"""Top-k Mixture-of-Experts block (GShard/Switch-style, capacity-bounded).

Counterpart of ``repro.models.moe``.  Routing runs in fp32 over a router
that ``init_moe`` makes in fp32 (a step's ``cast_params`` rounds it to the
compute dtype, and the fp32 activations meet that rounded router, as in the
reference).  Each token picks its top-k experts; the choices are ranked
k-major (every first choice before any second choice, tokens in order
within a rank), and a choice whose rank within its expert reaches the
expert's capacity is dropped.  Every expert then runs its SwiGLU over its
whole ``[C, d]`` capacity buffer, used or not, and each token sums its kept
choices' outputs weighted by its renormalised router probabilities.

A routing group is the set of tokens that share expert capacity: in decode
(``S == 1`` and ``B > 1``) the whole batch is one group of ``B`` tokens;
otherwise each batch row is a group of ``S`` tokens (prefill, chunked
prefill, the speculative verify chunk, training, and a decode at ``B ==
1``).  So a token's output depends on the other tokens of its group, padding
rows and idle slots included.  The groups ride a leading dimension (the
reference ``vmap``s over them).

The dispatch writes each kept choice to its ``(expert, rank)`` row of a
``[G, E * C + 1, d]`` buffer; a dropped choice writes the one scratch row
past ``E * C``, which is cut off before the experts run.  No value is
accumulated, so the result does not depend on the order of the writes, and
nothing here syncs with the host (no ``.item()``, no boolean-mask indexing):
the paged engine captures the decode step, this block included, as a CUDA
graph.  The reference's ``set_dispatch`` switch picks between two GSPMD
shardings of the same arithmetic; the port keeps one, and it is not kept.

Expert parallelism (an ``act_sharding`` context whose experts split over
``model``): the router and ``x`` are replicated, so ``route`` runs whole
on every model rank and ``aux`` / ``dropped`` come out identical
everywhere; only this rank's ``E/m`` experts' slice of the capacity buffer
goes through ``torch.bmm``, and the local experts' combine is summed over
``model``.  The aux loss's gradient is kept on model rank 0 only, so the
router's and ``x``'s gradient sums over ``model`` count it once.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import act_sharding as AS

Params = Any


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype) -> Params:
    """Same shapes and scales as ``repro.models.moe.init_moe`` (the router in
    fp32 whatever ``dtype`` is); the numbers come from ``gen``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dev = gen.device

    def normal(shape, dt):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt)

    return {
        "router": normal((d, e), torch.float32) * d**-0.5,
        "wg": normal((e, d, f), dtype) * d**-0.5,
        "wu": normal((e, d, f), dtype) * d**-0.5,
        "wd": normal((e, f, d), dtype) * f**-0.5,
    }


def expert_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert for a group of ``tokens_per_group`` tokens: at least
    8, a multiple of 8."""
    cap = tokens_per_group * cfg.experts_per_token * cfg.moe_capacity_factor
    cap = int(cap / cfg.num_experts) + 1
    return max(8, ((cap + 7) // 8) * 8)


def route(cfg: ModelConfig, p: Params, x: torch.Tensor, capacity: int):
    """x: [G, s, d], ``G`` routing groups of ``s`` tokens.  Returns ``(y
    [G, s, d], aux [G], dropped [G], ids [G, s, k])``: the block's output,
    each group's load-balancing loss and dropped share of choices, and the
    experts each token chose (in descending router probability).  ``p``'s
    expert weights may be this model rank's block of ``E/m`` experts: then
    ``y`` sums the local experts' outputs only."""
    g, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    e_loc = p["wg"].shape[0]
    e0 = AS.model_rank() * e_loc if e_loc < e else 0
    logits = x.float() @ p["router"].float()  # [G, s, e]
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1)  # [G, s, k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)

    # GShard priority: all first choices rank before any second choice, etc.
    ids_t = ids.transpose(1, 2).reshape(g, k * s)  # [G, k*s], k-major
    onehot = (ids_t[..., None] == torch.arange(e, device=x.device)).to(torch.int32)
    rank = (onehot.cumsum(1) - 1).gather(2, ids_t[..., None])[..., 0]  # [G, k*s]
    keep = rank < capacity
    dest = ids_t * capacity + rank.clamp(max=capacity - 1)  # the reference's
    # kept choices own their row; dropped ones write the scratch row E*C
    write = torch.where(keep, dest, e * capacity)

    xr = x.repeat(1, k, 1)  # [G, k*s, d], k-major
    buf = torch.zeros((g, e * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.scatter(1, write[..., None].expand(-1, -1, d), xr)
    h = buf[:, : e * capacity].reshape(g, e, capacity, d)[:, e0:e0 + e_loc]
    h = h.transpose(0, 1).reshape(e_loc, g * capacity, d)  # [E_loc, G*C, d]

    # per-expert SwiGLU over every capacity row
    gate = torch.bmm(h, p["wg"])
    up = torch.bmm(h, p["wu"])
    out = torch.bmm(F.silu(gate) * up, p["wd"])  # [E_loc, G*C, d]
    out = out.reshape(e_loc, g, capacity, d).transpose(0, 1).reshape(g, e_loc * capacity, d)

    wt = weights.transpose(1, 2).reshape(g, k * s)  # aligned with ids_t
    used = keep
    if e_loc < e:  # the kept choices of the local experts only
        dest = dest - e0 * capacity
        used = keep & (dest >= 0) & (dest < e_loc * capacity)
        dest = dest.clamp(0, e_loc * capacity - 1)
    y_r = out.gather(1, dest[..., None].expand(-1, -1, d))
    y_r = y_r * (wt * used).to(x.dtype)[..., None]
    y = y_r.reshape(g, k, s, d).sum(1)

    # load-balancing auxiliary loss (Switch): E * sum_e f_e * P_e
    me = (AS.once_over_model(probs) if e_loc < e else probs).mean(1)  # [G, e]
    ce = (ids[..., :1] == torch.arange(e, device=x.device)).float().mean(1)
    aux = e * (me * ce).sum(-1)
    dropped = 1.0 - keep.float().mean(-1)
    return y, aux, dropped, ids


def routing_groups(cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """x: [B, S, d] -> (x as [G, s, d] routing groups, their capacity): one
    group of the whole batch in decode (``S == 1 and B > 1``), else one
    group per batch row."""
    b, s, d = x.shape
    if s == 1 and b > 1:
        return x.reshape(1, b, d), expert_capacity(cfg, b)
    return x, expert_capacity(cfg, s)


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """x: [B, S, d] -> ``(y [B, S, d], aux_loss, drop_fraction)``, the last
    two fp32 scalars averaged over the routing groups."""
    ep = AS.split("ecd")
    # a decode batch split over the data axes routes as one group, as the
    # reference's unsplit batch does: gathered whole, this rank's rows kept
    decode = x.shape[1] == 1
    whole = AS.gather_batch(x) if decode else x
    groups, capacity = routing_groups(cfg, AS.copy_to_model(whole) if ep else whole)
    y, aux, dropped, _ = route(cfg, p, groups, capacity)
    y = y.reshape(whole.shape)
    y = AS.reduce_from_model(y) if ep else y
    return (AS.batch_rows(y, x.shape[0]) if decode else y), aux.mean(), dropped.mean()
