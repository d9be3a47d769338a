"""Data substrate: deterministic synthetic pipelines."""
from repro_torch.data import pipeline

__all__ = ["pipeline"]
