"""Decoder-only LM, dense family: the training forward and loss, and the
serving path.

Counterpart of ``repro.models.transformer`` for what the trainer and the
serving engine run: ``init_params``, ``embed_tokens`` / ``unembed``,
``forward`` / ``lm_loss`` (with remat policies ``"none"`` and ``"full"``),
``init_paged_cache`` and ``init_cache`` (the dense layout a speculative
engine's draft model keeps), ``decode_step``, the fused ``decode_loop`` and
``prefill_chunks_into_slots`` on either layout, and ``decode_chunk``, the
speculative target's chunk / tree verify pass on the paged layout.  The reference's ``lax.scan`` over stacked
layer weights becomes a Python loop over the ``[L, ...]`` stacks; its
donated caches become in-place updates of the cache dict's tensors
(documented per function).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Any


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise ValueError(
            f"the port runs the dense family only, not {cfg.family!r}"
        )


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(
    cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype = torch.float32
) -> Params:
    """Random weights on ``gen.device``, with the reference's tree, shapes and
    scales (``repro.models.transformer.init_params``).  The numbers come from
    the torch generator; tests that need the reference's weights go through
    ``repro_torch.bridge.params_from_numpy`` instead."""
    _require_dense(cfg)
    dev = gen.device
    params: dict = {
        "embed": torch.randn(
            (cfg.vocab_size, cfg.d_model), generator=gen, device=dev,
            dtype=dtype,
        ) * cfg.d_model**-0.5
    }
    per_layer = []
    for _ in range(cfg.num_layers):
        p = {
            "attn": L.init_attention(cfg, gen, cfg.d_model, dtype),
            "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
        }
        if cfg.parametric_norm:
            p["ln1"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
            p["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
        per_layer.append(p)
    params["layers"] = _stack(per_layer)
    if cfg.parametric_norm:
        params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=gen, device=dev,
            dtype=dtype,
        ) * cfg.d_model**-0.5
    return params


def _stack(trees: list) -> Params:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def cast_params(params: Params, compute_dtype: torch.dtype) -> Params:
    """fp32 leaves with ``ndim > 1`` cast to ``compute_dtype`` (the
    reference's in-step ``cast``); other leaves are returned as they are.
    A no-op on weights already in ``compute_dtype``."""
    if isinstance(params, dict):
        return {k: cast_params(v, compute_dtype) for k, v in params.items()}
    if params.dtype == torch.float32 and params.ndim > 1:
        return params.to(compute_dtype)
    return params


def _layer(stacked: Params, i: int) -> Params:
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_tokens(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    return params["embed"].to(dtype)[tokens.long()]


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


# ---------------------------------------------------------------------------
# Forward (train / logits over the full sequence) and loss
# ---------------------------------------------------------------------------

#: remat policies the port runs ("dots" is not ported yet)
REMAT_POLICIES = ("none", "full")


def _unstack(stacked: Params) -> list:
    """[L, ...] leaves -> one tree per layer, as views whose backward stacks
    the layers' gradients once (``torch.unbind``)."""
    if isinstance(stacked, dict):
        per_key = {k: _unstack(v) for k, v in stacked.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(stacked, 0))


def _dense_layer(
    cfg: ModelConfig, p: Params, x: torch.Tensor, impl: str
) -> torch.Tensor:
    h = L.norm(cfg, x, p.get("ln1"))
    x = x + L.attention_block(cfg, p["attn"], h, impl=impl)
    h = L.norm(cfg, x, p.get("ln2"))
    return x + L.mlp_block(p["ffn"], h)


def forward(
    cfg: ModelConfig,
    params: Params,
    inputs: torch.Tensor,
    *,
    impl: str = "auto",
    remat_policy: str = "none",
    compute_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, dict]:
    """inputs: int tokens [B, S].  Returns ``(logits [B, S, V], metrics)``.

    fp32 weights with ``ndim > 1`` are cast to ``compute_dtype`` inside the
    forward (differentiably, so their gradients arrive in fp32).
    ``remat_policy="full"`` recomputes each layer in the backward
    (``torch.utils.checkpoint``) instead of keeping its activations."""
    _require_dense(cfg)
    if remat_policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' (save matmul outputs only) is not ported yet"
        )
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    if inputs.is_floating_point():
        raise ValueError(f"{cfg.name} takes int tokens, not embeddings")
    x = embed_tokens(cfg, params, inputs, compute_dtype)
    for lp in _unstack(cast_params(params["layers"], compute_dtype)):
        if remat_policy == "full":
            x = checkpoint(_dense_layer, cfg, lp, x, impl, use_reentrant=False)
        else:
            x = _dense_layer(cfg, lp, x, impl)
    x = L.norm(cfg, x, params.get("final_norm"))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(cfg, params, x), {"moe_aux": zero, "moe_dropped": zero}


def lm_loss(
    cfg: ModelConfig,
    params: Params,
    inputs: torch.Tensor,
    labels: torch.Tensor,
    *,
    impl: str = "auto",
    remat_policy: str = "none",
    compute_dtype: torch.dtype = torch.bfloat16,
    moe_aux_weight: float = 0.01,
) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy over fp32 logits (plus the MoE aux
    term, zero for the dense family).  Returns ``(loss, metrics)`` with
    ``metrics`` holding ``ce``, ``loss``, ``moe_aux`` and ``moe_dropped``."""
    logits, metrics = forward(
        cfg, params, inputs, impl=impl, remat_policy=remat_policy,
        compute_dtype=compute_dtype,
    )
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = (logz - gold).mean()
    loss = ce + moe_aux_weight * metrics["moe_aux"]
    return loss, dict(metrics, ce=ce, loss=loss)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig,
    batch: int,
    max_seq: int,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> Params:
    """Dense decode cache: ``layers.k/v`` are [L, B, S, kvH, hd] rows per
    slot; ``index`` is [B] int32 (the reference starts from a scalar that
    its engine replaces with a [B] vector)."""
    _require_dense(cfg)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
        "layers": {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        },
    }



def init_paged_cache(
    cfg: ModelConfig,
    batch: int,
    num_pages: int,
    page_size: int,
    max_pages_per_slot: int,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> Params:
    """Paged decode cache: ``layers.k/v`` are [L, P, page, kvH, hd] pools of
    physical pages shared across slots; ``block_tables`` is [B, W] int32
    with ``W = max_pages_per_slot + 1``, whose last column stays at the
    sentinel page 0 so overflow writes land on a page nobody reads."""
    _require_dense(cfg)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
        "block_tables": torch.zeros(
            (batch, max_pages_per_slot + 1), dtype=torch.int32, device=device
        ),
        "layers": {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        },
    }


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    cache: Params,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
) -> tuple[torch.Tensor, Params]:
    """tokens: [B] int32 (last generated).  Returns ``(logits [B, V],
    cache)``: every layer writes the token's K/V into the paged pool or the
    dense cache in place, and the returned cache is a new dict whose
    ``index`` is advanced by one."""
    _require_dense(cfg)
    x = embed_tokens(cfg, params, tokens, compute_dtype)[:, None, :]
    idx = cache["index"]
    bt = cache.get("block_tables")  # None: the dense layout
    layers = cast_params(params["layers"], compute_dtype)
    k_all, v_all = cache["layers"]["k"], cache["layers"]["v"]
    for i in range(cfg.num_layers):
        lp = _layer(layers, i)
        h = L.norm(cfg, x, lp.get("ln1"))
        if bt is None:
            y, _ = L.attention_decode(
                cfg, lp["attn"], h, (k_all[i], v_all[i]), idx, impl=attn_impl
            )
        else:
            y, _ = L.attention_decode_paged(
                cfg, lp["attn"], h, (k_all[i], v_all[i]), bt, idx,
                impl=attn_impl,
            )
        x = x + y
        h = L.norm(cfg, x, lp.get("ln2"))
        x = x + L.mlp_block(lp["ffn"], h)
    x = L.norm(cfg, x, params.get("final_norm"))
    logits = unembed(cfg, params, x)[:, 0]
    return logits, dict(cache, index=idx + 1)


# ---------------------------------------------------------------------------
# Chunk-verify decode (the speculative target pass)
# ---------------------------------------------------------------------------


def chunk_recurrent_states(cfg: ModelConfig, layers: Params) -> Optional[Params]:
    """The rollback-relevant slice of a cache's ``layers``: ``None`` for the
    dense family, whose rollback is an index rewind.  The recurrent families
    are not ported."""
    _require_dense(cfg)
    return None


def merge_recurrent_states(cfg: ModelConfig, layers: Params, states) -> Params:
    """Inverse of ``chunk_recurrent_states``: the dense family's ``layers``
    as they are."""
    _require_dense(cfg)
    return layers


def decode_chunk(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    cache: Params,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
    anc: Optional[torch.Tensor] = None,
    depths: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Params, None]:
    """Score a T = gamma + 1 speculative chunk in ONE pass over the paged
    cache.  tokens: [B, T] int32, the current token plus gamma draft tokens.
    Returns ``(logits [B, T, V], cache, None)``: every layer writes the
    chunk's K/V into the pool in place, the returned cache's ``index`` is
    advanced by T, and the third item (the recurrent families' per-step
    states) is ``None``.

    Tree mode: ``anc`` [B, T] int32 ancestor bitmasks and ``depths`` [T]
    int32 node depths turn the rows into packed-tree nodes (node 0 = the
    current token) verified by the tree kernel.  The dense target layout
    (the reference's ``attention_verify``) is not ported yet."""
    _require_dense(cfg)
    bt = cache.get("block_tables")
    if bt is None:
        raise NotImplementedError(
            "decode_chunk over a dense target cache is not ported yet"
        )
    t = tokens.shape[1]
    x = embed_tokens(cfg, params, tokens, compute_dtype)  # [B, T, d]
    idx = cache["index"]
    layers = cast_params(params["layers"], compute_dtype)
    k_all, v_all = cache["layers"]["k"], cache["layers"]["v"]
    for i in range(cfg.num_layers):
        lp = _layer(layers, i)
        h = L.norm(cfg, x, lp.get("ln1"))
        y, _ = L.attention_verify_paged(
            cfg, lp["attn"], h, (k_all[i], v_all[i]), bt, idx,
            impl=attn_impl, anc=anc, depths=depths,
        )
        x = x + y
        h = L.norm(cfg, x, lp.get("ln2"))
        x = x + L.mlp_block(lp["ffn"], h)
    x = L.norm(cfg, x, params.get("final_norm"))
    return unembed(cfg, params, x), dict(cache, index=idx + t), None


def decode_loop(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    cache: Params,
    remaining: Optional[torch.Tensor] = None,
    *,
    k: int,
    max_seq: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
):
    """Run ``k`` greedy decode microsteps without a host sync.

    ``remaining``: [B] int32 per-slot budgets.  A slot is active while
    ``remaining > 0`` and (with ``max_seq``) its index is below
    ``max_seq - 1``; inactive slots are frozen: token, index and budget stay.
    ``remaining=None`` runs every slot.

    Returns ``(tokens, cache, remaining, toks_seq, steps, bad)``:
    ``toks_seq[j]`` is the [B] token vector after microstep ``j``,
    ``steps[i]`` the microsteps slot ``i`` was active for, ``bad[i]`` True
    if an active slot ever produced a non-finite logit.  All stay on the
    device, so the caller fetches them with ONE device -> host transfer.
    The pools are written in place."""
    b = tokens.shape[0]
    dev = tokens.device
    masked = remaining is not None
    rem = remaining if masked else torch.zeros((b,), dtype=torch.int32, device=dev)
    bad = torch.zeros((b,), dtype=torch.bool, device=dev)
    steps = torch.zeros((b,), dtype=torch.int32, device=dev)
    toks_seq = []
    for _ in range(k):
        idx = cache["index"]
        logits, new_c = decode_step(
            cfg, params, tokens, cache, compute_dtype=compute_dtype,
            attn_impl=attn_impl,
        )
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        finite = torch.isfinite(logits).all(dim=-1)
        if masked:
            active = rem > 0
            if max_seq is not None:
                active = active & (idx < max_seq - 1)
            tokens = torch.where(active, next_tok, tokens)
            cache = dict(new_c, index=torch.where(active, new_c["index"], idx))
            rem = torch.where(active, rem - 1, rem)
        else:
            tokens, cache = next_tok, new_c
            active = torch.ones((b,), dtype=torch.bool, device=dev)
        bad = bad | (active & ~finite)
        steps = steps + active.to(torch.int32)
        toks_seq.append(tokens)
    if toks_seq:
        toks = torch.stack(toks_seq)
    else:
        toks = torch.zeros((0, b), dtype=torch.int32, device=dev)
    return tokens, cache, rem, toks, steps, bad


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------


def prefill_chunks_into_slots(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    chunk_lens: torch.Tensor,
    cache: Params,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
    need_logits: bool = True,
) -> tuple[torch.Tensor, Params]:
    """One chunked-prefill microstep over ALL slots.

    tokens: [B, C] int32, one prompt chunk per slot, zero-padded past
    ``chunk_lens``; chunk_lens: [B] int32 (0 freezes a slot: no K/V write,
    no index advance); cache: the paged or dense cache with ``index`` [B]
    holding each slot's prefill progress.  Each layer writes the chunk's real
    K/V in place and attends it to the slot's earlier keys plus the chunk's
    causal triangle.

    Returns ``(next_tokens [B] int32, cache)`` with ``index`` advanced by
    ``chunk_lens``: ``next_tokens[b]`` is the argmax at chunk position
    ``max(chunk_lens[b] - 1, 0)`` (frozen slots give a token nobody reads).
    ``need_logits=False`` (the draft model's prefill, whose first-token
    logits are never read) skips the vocab projection and returns zeros."""
    _require_dense(cfg)
    x = embed_tokens(cfg, params, tokens, compute_dtype)  # [B, C, d]
    idx = cache["index"]
    lens = chunk_lens.to(torch.int32)
    bt = cache.get("block_tables")  # None: the dense layout
    layers = cast_params(params["layers"], compute_dtype)
    k_all, v_all = cache["layers"]["k"], cache["layers"]["v"]
    for i in range(cfg.num_layers):
        lp = _layer(layers, i)
        h = L.norm(cfg, x, lp.get("ln1"))
        if bt is None:
            y, _ = L.attention_prefill_chunk(
                cfg, lp["attn"], h, (k_all[i], v_all[i]), idx, lens,
                impl=attn_impl,
            )
        else:
            y, _ = L.attention_prefill_chunk_paged(
                cfg, lp["attn"], h, (k_all[i], v_all[i]), bt, idx, lens,
                impl=attn_impl,
            )
        x = x + y
        h = L.norm(cfg, x, lp.get("ln2"))
        x = x + L.mlp_block(lp["ffn"], h)
    new_cache = dict(cache, index=idx + lens)
    if not need_logits:
        return torch.zeros_like(lens), new_cache
    x = L.norm(cfg, x, params.get("final_norm"))
    pos = torch.clamp(lens - 1, min=0).long()
    last = x[torch.arange(x.shape[0], device=x.device), pos][:, None]  # [B, 1, d]
    logits = unembed(cfg, params, last)[:, 0]
    return torch.argmax(logits, dim=-1).to(torch.int32), new_cache
