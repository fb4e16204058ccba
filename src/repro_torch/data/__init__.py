"""Synthetic LM data for the port's trainer (numpy only)."""
from repro_torch.data.pipeline import SyntheticDataset

__all__ = ["SyntheticDataset"]
