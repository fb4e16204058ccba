"""Optimizer pieces of the train step (counterparts of ``repro.optim``):
AdamW with fp32 moments, global-norm clipping, learning-rate schedules,
int8 error-feedback gradient compression."""
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compression import compressed_psum, ef_int8_compress_decompress
from repro_torch.optim.schedule import make_schedule

__all__ = [
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "compressed_psum",
    "ef_int8_compress_decompress",
    "global_norm",
    "make_schedule",
]
