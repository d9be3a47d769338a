"""Bitmaps, step counts and device resolution."""
