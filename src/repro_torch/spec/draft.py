"""Draft-model proposer: ``gamma`` speculative tokens per slot (counterpart
of ``repro.spec.draft``).

The draft runs ``gamma + 1`` single-token decode steps: steps
``0 .. gamma - 1`` produce the draft tokens, and the last, *catch-up* step
consumes the last draft token so that a fully accepted chunk leaves the
draft cache aligned with the target (both rewind to
``index + accepted + 1``, see ``spec.loop``).  The reference's ``lax.scan``
is a Python loop; nothing is fetched to the host.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.spec.verify import gumbel_noise


def draft_propose(
    cfg: ModelConfig,
    params,
    token: torch.Tensor,
    cache,
    *,
    gamma: int,
    mode: str = "greedy",
    gen: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
):
    """Propose ``gamma`` draft tokens per slot after ``token`` [B] int32.

    ``mode``: "greedy" (argmax chain) or "sample" (categorical draws from
    ``gen``, which also return the per-step draft distributions for the
    residual test).

    Returns ``(draft_tokens [B, gamma], draft_probs [B, gamma, V] | None,
    cache, step_states)``; ``step_states`` is ``None`` (the dense family
    rolls back by an index rewind).  The cache index advances by
    ``gamma + 1`` and the draft's K/V is written in place; callers
    overwrite the index with the post-acceptance one."""
    assert mode in ("greedy", "sample"), mode
    if mode == "sample" and gen is None:
        raise ValueError("a sampling draft needs a torch.Generator")
    toks, probs = [], []
    tok = token
    for _ in range(gamma + 1):
        logits, cache = T.decode_step(
            cfg, params, tok, cache, compute_dtype=compute_dtype,
            attn_impl=attn_impl,
        )
        logits32 = logits.float()
        if mode == "sample":
            noise = gumbel_noise(logits32.shape, gen, logits32.device)
            tok = torch.argmax(logits32 + noise, dim=-1).to(torch.int32)
            probs.append(torch.softmax(logits32, dim=-1))
        else:
            tok = torch.argmax(logits32, dim=-1).to(torch.int32)
        toks.append(tok)
    # the catch-up step's token is dropped
    draft_tokens = torch.stack(toks[:gamma], dim=1)
    draft_probs = torch.stack(probs[:gamma], dim=1) if probs else None
    return draft_tokens, draft_probs, cache, T.chunk_recurrent_states(
        cfg, cache["layers"]
    )
