"""The speculative decode loop: k propose / verify / accept rounds with ONE
device -> host fetch per loop (counterpart of ``repro.spec.loop``; the
reference's ``lax.scan`` is a Python loop whose outputs stay on the device).

Round anatomy (per slot, ragged over the batch):

  1. the draft proposes ``gamma`` tokens (+1 catch-up step, ``spec.draft``)
  2. the target scores the ``gamma + 1`` chunk in one pass
     (``transformer.decode_chunk`` -> the paged chunk-verify kernel)
  3. acceptance keeps the longest admissible prefix (``spec.verify``)
  4. both caches rewind to ``index + accepted + 1`` (``spec.rollback``)

A slot is active while its budget holds and its cache can still fit a whole
chunk (``index + gamma < max_seq``); frozen slots keep token, index and
budget.  A frozen slot's region may still receive (ignored) chunk writes,
harmless under the stale-overwrite invariant.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.spec.draft import draft_propose
from repro_torch.spec.rollback import rollback_recurrent
from repro_torch.spec.verify import greedy_accept, sampled_accept, simulated_accept

MODES = ("greedy", "simulated", "sample")


def spec_round(
    cfg: ModelConfig,
    draft_cfg: ModelConfig,
    params,
    draft_params,
    carry,
    *,
    gamma: int,
    mode: str,
    max_seq: int,
    sim_accept_p: float = 0.9,
    gen: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
):
    """One propose / verify / accept round.  carry = (tokens, cache,
    draft_cache, remaining); returns ``(carry, (out_tokens [B, gamma + 1],
    n_out [B], accepted [B], proposed [B], bad [B]))``.  ``bad`` flags an
    active slot whose verify logits hold a non-finite value.  The random
    modes draw from ``gen``."""
    if mode not in MODES:
        raise ValueError(f"unknown speculative mode {mode!r}")
    if mode != "greedy" and gen is None:
        raise ValueError(f"mode {mode!r} needs a torch.Generator")
    tokens, cache, dcache, rem = carry
    idx0 = cache["index"]
    active = (rem > 0) & (idx0 + gamma < max_seq)
    old_t = T.chunk_recurrent_states(cfg, cache["layers"])
    old_d = T.chunk_recurrent_states(draft_cfg, dcache["layers"])

    d_toks, d_probs, dcache, d_states = draft_propose(
        draft_cfg, draft_params, tokens, dcache, gamma=gamma,
        mode="sample" if mode == "sample" else "greedy", gen=gen,
        compute_dtype=compute_dtype, attn_impl=attn_impl,
    )
    chunk = torch.cat([tokens[:, None], d_toks], dim=1)  # [B, gamma + 1]
    logits, cache, t_states = T.decode_chunk(
        cfg, params, chunk, cache, compute_dtype=compute_dtype,
        attn_impl=attn_impl,
    )
    bad = active & ~torch.isfinite(logits).all(dim=-1).all(dim=-1)
    if mode == "greedy":
        a, nxt, out, a_match = greedy_accept(d_toks, logits, rem)
    elif mode == "simulated":
        a, nxt, out, a_match = simulated_accept(gen, sim_accept_p, d_toks, logits, rem)
    else:
        a, nxt, out, a_match = sampled_accept(gen, d_toks, d_probs, logits, rem)

    n_out = torch.where(active, a + 1, torch.zeros_like(a))
    new_idx = torch.where(active, idx0 + a + 1, idx0).to(torch.int32)
    tokens = torch.where(active, nxt, tokens)
    cache = dict(
        cache, index=new_idx,
        layers=T.merge_recurrent_states(
            cfg, cache["layers"],
            rollback_recurrent(cfg, t_states, a, active, old_t),
        ),
    )
    dcache = dict(
        dcache, index=new_idx,
        layers=T.merge_recurrent_states(
            draft_cfg, dcache["layers"],
            rollback_recurrent(draft_cfg, d_states, a, active, old_d),
        ),
    )
    rem = rem - n_out
    out = torch.where(active[:, None], out, torch.zeros_like(out))
    # acceptance stats use the unclamped run: a budget cut is not a draft
    # rejection, so it must not depress the gamma controller's EWMA
    accepted = torch.where(active, a_match, torch.zeros_like(a_match))
    proposed = active.to(torch.int32) * gamma
    return (tokens, cache, dcache, rem), (out, n_out, accepted, proposed, bad)


def spec_decode_loop(
    cfg: ModelConfig,
    draft_cfg: ModelConfig,
    params,
    draft_params,
    tokens: torch.Tensor,
    cache,
    draft_cache,
    remaining: torch.Tensor,
    *,
    k: int,
    gamma: int,
    mode: str = "greedy",
    max_seq: int,
    sim_accept_p: float = 0.9,
    gen: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
):
    """Run ``k`` speculative rounds.

    Returns ``(tokens, cache, draft_cache, remaining, out_tokens
    [k, B, gamma + 1], n_out [k, B], accepted [k, B], proposed [k, B],
    bad [B])`` -- the reference's tuple without its PRNG key (the generator
    carries its own state).  Round j emitted ``n_out[j, i]`` verified tokens
    ``out_tokens[j, i, :n]`` for slot i; ``bad[i]`` flags slot i's verify
    logits going non-finite in any round.  Everything stays on the device,
    so the caller fetches it with ONE transfer."""
    if k < 1:
        raise ValueError(f"spec_decode_loop needs k >= 1, got {k}")
    carry = (tokens, cache, draft_cache, remaining)
    ys = []
    for _ in range(k):
        carry, y = spec_round(
            cfg, draft_cfg, params, draft_params, carry, gamma=gamma,
            mode=mode, max_seq=max_seq, sim_accept_p=sim_accept_p, gen=gen,
            compute_dtype=compute_dtype, attn_impl=attn_impl,
        )
        ys.append(y)
    tokens, cache, draft_cache, remaining = carry
    out_tokens, n_out, accepted, proposed, bad = (torch.stack(v) for v in zip(*ys))
    return (
        tokens, cache, draft_cache, remaining,
        out_tokens, n_out, accepted, proposed, bad.any(dim=0),
    )
