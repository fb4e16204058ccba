"""The train step (counterpart of ``repro.runtime.step``'s
``make_train_step`` and its ``TrainStepArtifacts``: on one device, or over
a mesh as ``ShardedTrainStep``), the serve steps on a mesh (``make_serve_step`` /
``make_prefill_step``), the sharding rules (``runtime.sharding``) and the
fault-tolerant ``Trainer`` over the step (counterpart of
``repro.runtime.trainer``)."""
from repro_torch.runtime.step import (
    ServeStepArtifacts,
    ShardedTrainStep,
    TrainStepArtifacts,
    abstract_batch,
    abstract_cache,
    abstract_params,
    abstract_train_state,
    init_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.runtime.trainer import Trainer, TrainerReport, specinf_backoff

__all__ = ["ServeStepArtifacts", "ShardedTrainStep", "Trainer", "TrainerReport",
           "TrainStepArtifacts",
           "abstract_batch", "abstract_cache", "abstract_params", "abstract_train_state",
           "init_train_state", "make_prefill_step", "make_serve_step", "make_train_step",
           "specinf_backoff"]
