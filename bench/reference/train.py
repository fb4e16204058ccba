"""The plain reference of the training step: the reference model's mean
next-token cross-entropy, ``torch.nn.utils.clip_grad_norm_`` and
``torch.optim.AdamW`` (decoupled weight decay on every leaf), under linear
warm-up then cosine decay of the learning rate, the step count taken before
the update.  Imports nothing of the program."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.model import forward


def lr_at(t: int, train: dict) -> float:
    """Learning rate of step ``t`` (0-based)."""
    peak, warm, total = train["learning_rate"], train["warmup_steps"], train["total_steps"]
    frac = min(t / max(warm, 1), 1.0)
    x = min(max((t - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * frac * 0.5 * (1.0 + math.cos(math.pi * x))


def train_steps(m: dict, train: dict, params: dict, batches: list, *,
                mode: str = "fp32") -> dict:
    """Run ``len(batches)`` steps on ``params`` (``{path: float32 tensor}``,
    updated in place).  Returns the losses and, of the first and the
    second step, each leaf's gradient norm after clipping (what the
    optimizer is given)."""
    leaves = list(params.values())
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=0.0, betas=(train["beta1"], train["beta2"]),
                            eps=train["eps"], weight_decay=train["weight_decay"], foreach=False)
    losses, grads = [], []
    for t, batch in enumerate(batches):
        for group in opt.param_groups:
            group["lr"] = lr_at(t, train)
        logits = forward(m, params, batch["inputs"], mode=mode, remat=True)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               batch["labels"].reshape(-1).long())
        del logits
        loss.backward()
        torch.nn.utils.clip_grad_norm_(leaves, train["grad_clip_norm"], foreach=False)
        losses.append(loss.item())
        if t < 2:
            grads.append({k: p.grad.norm().item() for k, p in params.items()})
        opt.step()
        opt.zero_grad(set_to_none=True)
    del opt
    for p in leaves:
        p.requires_grad_(False)
    return {"losses": losses, "first_grad_norms": grads[0], "second_grad_norms": grads[1]}
