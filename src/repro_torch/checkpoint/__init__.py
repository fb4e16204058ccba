"""Atomic, fsync'd, torn-save-tolerant checkpoints of tensors and arrays."""
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
