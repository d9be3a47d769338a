"""Prefill/decode steps and generate."""
