"""The single-device train step (counterpart of ``repro.runtime.step``'s
``make_train_step`` without the mesh) and the fault-tolerant ``Trainer``
over it (counterpart of ``repro.runtime.trainer``)."""
from repro_torch.runtime.step import init_train_state, make_train_step
from repro_torch.runtime.trainer import Trainer, TrainerReport, specinf_backoff

__all__ = ["Trainer", "TrainerReport", "init_train_state", "make_train_step",
           "specinf_backoff"]
