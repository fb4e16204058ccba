"""The train step (counterpart of ``repro.runtime.step``'s
``make_train_step``: on one device, or over a mesh's data axes as
``ShardedTrainStep``), the sharding rules (``runtime.sharding``) and the
fault-tolerant ``Trainer`` over the step (counterpart of
``repro.runtime.trainer``)."""
from repro_torch.runtime.step import (
    ShardedTrainStep,
    abstract_params,
    init_train_state,
    make_train_step,
)
from repro_torch.runtime.trainer import Trainer, TrainerReport, specinf_backoff

__all__ = ["ShardedTrainStep", "Trainer", "TrainerReport", "abstract_params",
           "init_train_state", "make_train_step", "specinf_backoff"]
