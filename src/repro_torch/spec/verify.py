"""Acceptance rules of the target's chunk-verify pass (counterpart of
``repro.spec.verify``).

Each rule takes the target logits over the ``T = gamma + 1`` chunk
positions (current token + gamma drafts) and returns, per slot:

  * ``a``       -- accepted draft count, clamped so the round emits at most
                   ``remaining`` tokens (``a + 1 <= remaining``)
  * ``nxt``     -- the next current token (the correction at the first
                   rejection, or the bonus when every draft passes)
  * ``out``     -- the emitted row [B, gamma + 1]; entries past ``a`` are 0
  * ``a_match`` -- the unclamped accepted run, the draft-quality signal (a
                   budget cut is not a rejection)

``greedy_accept`` accepts draft j iff it equals the target argmax at chunk
position j, so the emitted tokens are exactly the plain greedy chain.
``sampled_accept`` is the speculative-sampling ratio test with residual
resampling; ``simulated_accept`` (benchmarks only) draws the match outcome
from a Bernoulli(p) stream.  The two random rules come in two forms: the
``*_with`` form takes its uniform draws (and, for sampling, the Gumbel noise
of the residual categorical draw) as tensors, so a test can feed it the
very numbers another implementation drew; the plain form draws them from a
``torch.Generator``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _leading_run(match: torch.Tensor) -> torch.Tensor:
    """[B, g] bool -> [B] int32 length of the leading all-True run."""
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)


def _emit(draft_tokens: torch.Tensor, a: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """Row [B, g + 1]: accepted drafts, then the target-sourced next token."""
    g = draft_tokens.shape[1]
    jpos = torch.arange(g + 1, device=draft_tokens.device)[None, :]
    d_pad = F.pad(draft_tokens, (0, 1))
    zero = torch.zeros_like(d_pad)
    return torch.where(
        jpos < a[:, None], d_pad,
        torch.where(jpos == a[:, None], nxt[:, None].to(d_pad.dtype), zero),
    )


def _clamp(a_match: torch.Tensor, remaining: torch.Tensor, g: int) -> torch.Tensor:
    return torch.clamp(torch.minimum(a_match, remaining - 1), 0, g).to(torch.int32)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for a [B, T(, ...)] tensor and [B] indices."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def greedy_accept(
    draft_tokens: torch.Tensor,  # [B, g] int32
    target_logits: torch.Tensor,  # [B, g + 1, V]
    remaining: torch.Tensor,  # [B] int32 token budgets
):
    g = draft_tokens.shape[1]
    tgt = torch.argmax(target_logits, dim=-1).to(torch.int32)  # [B, g + 1]
    a_match = _leading_run(draft_tokens == tgt[:, :g])
    a = _clamp(a_match, remaining, g)
    # tgt[a] is the correction at a rejection, the bonus when every draft
    # passes, and the accepted draft itself at a budget cut
    nxt = _take(tgt, a)
    return a, nxt, _emit(draft_tokens, a, nxt), a_match


def simulated_accept_with(
    u: torch.Tensor,  # [B, g] uniform draws in [0, 1)
    accept_p: float,
    draft_tokens: torch.Tensor,
    target_logits: torch.Tensor,
    remaining: torch.Tensor,
):
    g = draft_tokens.shape[1]
    tgt = torch.argmax(target_logits, dim=-1).to(torch.int32)
    a_match = _leading_run(u < accept_p)
    a = _clamp(a_match, remaining, g)
    nxt = _take(tgt, a)
    return a, nxt, _emit(draft_tokens, a, nxt), a_match


def simulated_accept(
    gen: torch.Generator,
    accept_p: float,
    draft_tokens: torch.Tensor,
    target_logits: torch.Tensor,
    remaining: torch.Tensor,
):
    u = torch.rand(draft_tokens.shape, generator=gen, device=draft_tokens.device)
    return simulated_accept_with(u, accept_p, draft_tokens, target_logits, remaining)


def gumbel_noise(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise: ``argmax(logits + noise)`` is a categorical
    draw from ``softmax(logits)``."""
    u = torch.rand(shape, generator=gen, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def sampled_accept_with(
    u: torch.Tensor,  # [B, g] uniform draws of the ratio test
    gumbel: torch.Tensor,  # [B, V] Gumbel noise of the residual draw
    draft_tokens: torch.Tensor,  # [B, g] int32
    draft_probs: torch.Tensor,  # [B, g, V] full draft distributions
    target_logits: torch.Tensor,  # [B, g + 1, V]
    remaining: torch.Tensor,
):
    b, g = draft_tokens.shape
    p_t = torch.softmax(target_logits.float(), dim=-1)
    sel = draft_tokens.long()[..., None]
    p_t_d = torch.gather(p_t[:, :g], -1, sel)[..., 0]  # [B, g]
    p_d_d = torch.gather(draft_probs, -1, sel)[..., 0]
    # accept iff u < p_t / p_d, multiplied through so p_d == 0 rejects
    a_match = _leading_run(u * p_d_d < p_t_d)
    a = _clamp(a_match, remaining, g)
    # residual max(p_t - p_d, 0) renormalised at the cut position; when every
    # draft passes the padded draft row is zero and it is the bonus sample
    p_t_a = _take(p_t, a)
    p_d_a = _take(F.pad(draft_probs, (0, 0, 0, 1)), a)
    res = torch.clamp(p_t_a - p_d_a, min=0.0)
    res_sum = res.sum(dim=-1, keepdim=True)
    dist = torch.where(res_sum > 0, res / torch.clamp(res_sum, min=1e-30), p_t_a)
    nxt_sampled = torch.argmax(torch.log(dist + 1e-38) + gumbel, dim=-1).to(torch.int32)
    # a budget cut emits the already-accepted draft token at the cut
    d_at_a = _take(F.pad(draft_tokens, (0, 1)), a)
    nxt = torch.where(a < a_match, d_at_a, nxt_sampled)
    return a, nxt, _emit(draft_tokens, a, nxt), a_match


def sampled_accept(
    gen: torch.Generator,
    draft_tokens: torch.Tensor,
    draft_probs: torch.Tensor,
    target_logits: torch.Tensor,
    remaining: torch.Tensor,
):
    dev = draft_tokens.device
    u = torch.rand(draft_tokens.shape, generator=gen, device=dev)
    noise = gumbel_noise((draft_tokens.shape[0], target_logits.shape[-1]), gen, dev)
    return sampled_accept_with(
        u, noise, draft_tokens, draft_probs, target_logits, remaining
    )
