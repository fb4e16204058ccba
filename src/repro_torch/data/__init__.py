"""Synthetic LM data for the port's trainer (numpy only)."""
from repro_torch.data.pipeline import SyntheticDataset, make_train_iterator

__all__ = ["SyntheticDataset", "make_train_iterator"]
