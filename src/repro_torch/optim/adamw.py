"""AdamW over nested-dict parameter trees with fp32 moments (counterpart of
``repro.optim.adamw``).

The reference returns new trees; here the parameters and moments are
updated IN PLACE (the reference's jit donates them) so that a full-size
model keeps one copy of each on the card, and the same trees are returned.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import tree_leaves, tree_map


def adamw_init(params) -> dict:
    """Zero fp32 moments shaped like ``params`` and a step count of 0 (an
    int32 scalar on the parameters' device)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, *, lr, cfg: TrainConfig):
    """One AdamW step at learning rate ``lr`` (a float or a scalar tensor):
    ``mu``, ``nu``, ``step`` and ``params`` are updated in place (the step
    counter too, so a graph that replays the update keeps the caller's
    tensor); returns ``(params, opt_state)``.  Bias corrections use the
    incremented step, as the reference does."""
    step = opt_state["step"].add_(1)
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    for g, mu, nu, p in zip(
        tree_leaves(grads), tree_leaves(opt_state["mu"]),
        tree_leaves(opt_state["nu"]), tree_leaves(params),
    ):
        g = g.float()
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        p32 = p.float()
        delta = (mu / c1) / (torch.sqrt(nu / c2) + eps) + wd * p32
        p.copy_(p32 - lr * delta)
    return params, opt_state
