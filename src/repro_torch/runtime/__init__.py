"""The single-device train step (counterpart of ``repro.runtime.step``'s
``make_train_step`` without the mesh)."""
from repro_torch.runtime.step import init_train_state, make_train_step

__all__ = ["init_train_state", "make_train_step"]
