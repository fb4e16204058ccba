"""Global-norm gradient clipping (counterpart of ``repro.optim.clip``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.tree import tree_leaves


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, norm: Optional[torch.Tensor] = None):
    """Scale ``grads`` IN PLACE by ``min(1, max_norm / norm)`` (the step owns
    its gradient tensors); returns ``(grads, norm)``.  ``norm`` is the
    global norm when ``grads`` are shards of the tree (taken over every
    shard by the caller), else ``global_norm(grads)``."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.copy_(g.float() * scale)
    return grads, norm
