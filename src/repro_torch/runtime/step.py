"""Single-device train step: microbatched gradient accumulation in fp32 ->
global-norm clip -> schedule -> AdamW (what ``repro.runtime.step``'s
``make_train_step`` does, without the mesh and its sharding specs).

The state is ``{"params", "opt"}`` as in the reference, plus ``"err"``
(fp32 error-feedback buffers shaped like the params) under
``grad_compression="int8_ef"``: there each fp32 gradient leaf is quantized
to int8 and dequantized with error feedback
(``optim.ef_int8_compress_decompress``) before the clip, as the
reference's step does at world size 1.  The step updates
the parameters and the optimizer state IN PLACE (the reference's jit
donates them) and returns the same state dict: a full-size model keeps one
copy of its weights, moments and gradients on the card.  Batches may be
numpy arrays (``SyntheticDataset``) or tensors; they are moved to the
step's device.  ``inputs`` are int tokens [B, S], or for an
``embed_inputs`` config (audio, VLM) fp32 embeddings [B, S, d_model], which
go through the copy and the microbatch split unchanged (the reference's
``abstract_batch``).  Every launch goes to the current stream and nothing
waits for the device: the metrics are device scalars.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    ef_int8_compress_decompress,
    make_schedule,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any

GRAD_COMPRESSIONS = ("none", "int8_ef")


def init_train_state(params: Tree, tcfg: Optional[TrainConfig] = None) -> dict:
    """``{"params", "opt"}`` over a trainable copy of ``params`` with fresh
    AdamW state, and ``"err"`` (fp32 zeros shaped like the params) when
    ``tcfg.grad_compression == "int8_ef"``.  The step updates the copy in
    place, so the caller's tensors (and an engine built on them) keep the
    initial weights, as the reference's immutable arrays do."""
    own = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    state = {"params": own, "opt": adamw_init(own)}
    if tcfg is not None and tcfg.grad_compression == "int8_ef":
        state["err"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), own)
    return state


def _microbatch(x: torch.Tensor, n_micro: int, j: int) -> torch.Tensor:
    """Microbatch ``j`` of ``n_micro``: rows j, j + n, j + 2n, ... -- the
    reference's split (the microbatch index is the batch dim's minor
    position)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    return x.reshape(b // n_micro, n_micro, *x.shape[1:])[:, j]


def make_train_step(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    *,
    device: Optional[str | torch.device] = None,
) -> Callable[[dict, dict], tuple[dict, dict]]:
    """``(state, batch) -> (state, metrics)`` with metrics ``loss``, ``ce``,
    ``moe_aux``, ``grad_norm`` and ``lr`` (fp32 scalar tensors).  The device
    is ``cuda`` unless the caller passes one; attention runs the flash
    kernels on CUDA and their plain version on the CPU."""
    if tcfg.grad_compression not in GRAD_COMPRESSIONS:
        raise NotImplementedError(
            f"grad_compression={tcfg.grad_compression!r}: the port has "
            f"{GRAD_COMPRESSIONS}"
        )
    int8_ef = tcfg.grad_compression == "int8_ef"
    device = resolve_device(device)
    schedule = make_schedule(tcfg)
    compute_dtype = getattr(torch, tcfg.compute_dtype)
    n_micro = max(1, tcfg.microbatches)

    def loss_and_grads(params, inputs, labels):
        loss, metrics = T.lm_loss(
            cfg, params, inputs, labels,
            remat_policy=tcfg.remat_policy, compute_dtype=compute_dtype,
        )
        leaves = tree_leaves(params)
        # an ``embed_inputs`` config never reads its embedding table here:
        # its gradient is zero, as JAX's is for an unused leaf
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), metrics, grads

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params, opt = state["params"], state["opt"]
        inputs = torch.as_tensor(batch["inputs"], device=device)
        labels = torch.as_tensor(batch["labels"], device=device)
        if n_micro == 1:
            loss, metrics, grads = loss_and_grads(params, inputs, labels)
            grads = [g.float() for g in grads]
            ce, aux = metrics["ce"].detach(), metrics["moe_aux"].detach()
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tree_leaves(params)]
            losses, ces, auxes = [], [], []
            for j in range(n_micro):
                l, m, g = loss_and_grads(
                    params, _microbatch(inputs, n_micro, j),
                    _microbatch(labels, n_micro, j),
                )
                for acc, gj in zip(grads, g):
                    acc.add_(gj.float())
                losses.append(l)
                ces.append(m["ce"].detach())
                auxes.append(m["moe_aux"].detach())
            for acc in grads:
                acc.div_(n_micro)
            loss = torch.stack(losses).mean()
            ce, aux = torch.stack(ces).mean(), torch.stack(auxes).mean()
        if int8_ef:
            if "err" not in state:
                raise ValueError("grad_compression='int8_ef' needs state['err']: build "
                                 "the state with init_train_state(params, tcfg)")
            with torch.no_grad():
                for i, err in enumerate(tree_leaves(state["err"])):
                    # the dequantized gradient replaces the gradient; the
                    # residual is the next step's error feedback
                    grads[i], new_err = ef_int8_compress_decompress(grads[i], err)
                    err.copy_(new_err)
        grads, gnorm = clip_by_global_norm(tree_unflatten(params, grads), tcfg.grad_clip_norm)
        lr = schedule(opt["step"])
        adamw_update(grads, opt, params, lr=lr, cfg=tcfg)
        return state, {"loss": loss, "ce": ce, "moe_aux": aux, "grad_norm": gnorm, "lr": lr}

    return train_step
