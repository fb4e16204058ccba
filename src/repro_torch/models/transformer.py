"""Decoder-only LM, dense, Mixture-of-Experts (``moe``), Mamba1 (``ssm``),
Zamba2 hybrid (``hybrid``), audio and VLM families: the training forward and
loss, and the serving path (all six).  The audio and VLM
families are the dense backbone over a stub frontend (``embed_inputs``):
``forward``, ``lm_loss`` and the monolithic ``prefill`` also take
precomputed ``[B, S, d_model]`` embeddings in place of tokens, as the
reference's do.

Counterpart of ``repro.models.transformer`` for what the trainer and the
serving engine run: ``init_params``, ``embed_tokens`` / ``unembed``,
``forward`` / ``lm_loss`` (every family, with remat policies ``"none"``,
``"dots"`` and ``"full"``), ``init_paged_cache`` and
``init_cache`` (dense rows, the Mamba1 conv / SSM state, or the hybrid's
Mamba2 state per cycle and layer beside the shared block's K/V rows per
cycle), ``decode_step``, the fused
``decode_loop``, ``prefill_chunks_into_slots`` on either KV layout,
monolithic bucket prefill (``prefill``, ``prefill_into_slot``,
``prefill_into_slot_paged``, ``prefill_suffix_into_slot``), and
``decode_chunk``, the speculative target's pass: chunk / tree verify on
either KV layout for the attention families, ``decode_step`` T times with
the recurrent state captured after each step for Mamba1 and the hybrid.
The reference's ``lax.scan`` over stacked layer weights becomes a Python
loop over the ``[L, ...]`` stacks; its donated caches become in-place
updates of the cache dict's tensors (documented per function).

The hybrid keeps the reference's layout: its Mamba2 layers are stacked
``[n_cyc, shared_attn_every, ...]`` and ``params["shared"]`` holds the ONE
attention + MLP block that runs before each cycle's layers.  Its attention
is dense only (no paged KV, no chunked prefill), as in the reference.

Under an ``act_sharding`` context on a model axis larger than 1 (the
sharded train step and the serve steps of ``runtime.step``) the attention
families run on this rank's weight blocks: the embedding table and LM head
split over the vocab (``embed_tokens`` a masked lookup in the local rows,
then one all-reduce; ``unembed`` this rank's logit columns; ``lm_loss`` a
logsumexp and a gold logit reduced over the split vocab, the full logits
never gathered), attention and MLP Megatron-style (``models.layers``),
the MoE block over the local experts (``models.moe``), Mamba1's and
Mamba2's mixers on the rank's ``d_inner`` block (``models.ssm``; the
hybrid's shared block through the Megatron path, remat ``"full"``
recomputing a cycle with its collectives), and the monolithic ``prefill``
and ``decode_step`` on the local dense cache and recurrent state.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import act_sharding as AS
from repro_torch.models import fsdp as FS
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.tree import tree_leaves, tree_map

Params = Any


#: the families the port runs: attention + MLP, attention + top-k experts,
#: Mamba1, Mamba2 layers with a shared attention + MLP block (Zamba2), and
#: the dense layer over audio frame / image patch embeddings
FAMILIES = ("dense", "moe", "audio", "vlm", "ssm", "hybrid")
#: the families whose layers hold attention (a KV cache, paged or dense);
#: every one but ``moe`` takes the dense layer
ATTENTION_FAMILIES = ("dense", "moe", "audio", "vlm")


def _require_family(cfg: ModelConfig, families: tuple = FAMILIES) -> None:
    if cfg.family not in families:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} not in {families} here")


def _require_attention(cfg: ModelConfig) -> None:
    _require_family(cfg, ATTENTION_FAMILIES)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(
    cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype = torch.float32
) -> Params:
    """Random weights on ``gen.device``, with the reference's tree, shapes and
    scales (``repro.models.transformer.init_params``).  The numbers come from
    the torch generator; tests that need the reference's weights go through
    ``repro_torch.bridge.params_from_numpy`` instead.  The hybrid's layers
    are stacked ``[n_cyc, shared_attn_every, ...]`` beside
    ``params["shared"]``."""
    _require_family(cfg)
    dev = gen.device
    params: dict = {
        "embed": torch.randn(
            (cfg.vocab_size, cfg.d_model), generator=gen, device=dev,
            dtype=dtype,
        ) * cfg.d_model**-0.5
    }
    stacked = None
    for i in range(cfg.num_layers):
        if cfg.family in ("ssm", "hybrid"):
            p = {"mixer": (SSM.init_mamba1 if cfg.family == "ssm" else SSM.init_mamba2)(
                cfg, gen, dtype)}
            if cfg.parametric_norm:
                p["ln"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
        else:
            p = {"attn": L.init_attention(cfg, gen, cfg.d_model, dtype)}
            p["ffn"] = (MOE.init_moe(cfg, gen, dtype) if cfg.family == "moe"
                        else L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype))
            if cfg.parametric_norm:
                p["ln1"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
                p["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
        # one layer at a time into the [L, ...] stacks: the peak is the
        # weights plus one layer, not twice the weights
        if stacked is None:
            stacked = _empty_stack(p, cfg.num_layers)
        _set_layer(stacked, i, p)
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        stacked = tree_map(
            lambda t: t.reshape(cfg.num_layers // every, every, *t.shape[1:]), stacked)
        params["shared"] = {
            "attn": L.init_attention(cfg, gen, cfg.d_model, dtype),
            "ffn": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
        }
        if cfg.parametric_norm:
            params["shared"]["ln1"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
            params["shared"]["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    params["layers"] = stacked
    if cfg.parametric_norm:
        params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=gen, device=dev,
            dtype=dtype,
        ) * cfg.d_model**-0.5
    return params


def _empty_stack(tree: Params, n: int) -> Params:
    if isinstance(tree, dict):
        return {k: _empty_stack(v, n) for k, v in tree.items()}
    return torch.empty((n, *tree.shape), dtype=tree.dtype, device=tree.device)


def _set_layer(stacked: Params, i: int, tree: Params) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _set_layer(stacked[k], i, v)
        else:
            stacked[k][i] = v


def cast_params(params: Params, compute_dtype: torch.dtype) -> Params:
    """fp32 leaves with ``ndim > 1`` cast to ``compute_dtype`` (the
    reference's in-step ``cast``); other leaves are returned as they are.
    A no-op on weights already in ``compute_dtype``."""
    if isinstance(params, dict):
        return {k: cast_params(v, compute_dtype) for k, v in params.items()}
    if params.dtype == torch.float32 and params.ndim > 1:
        return params.to(compute_dtype)
    return params


def _layer(stacked: Params, i) -> Params:
    """Layer ``i`` of a stack (an int, or a (cycle, layer) pair for the
    hybrid's ``[n_cyc, every, ...]`` stacks), as views."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def _layer_access(params: Params, compute_dtype: torch.dtype):
    """``i -> layer i`` of ``params["layers"]`` in ``compute_dtype`` (a
    cycle's ``[every, ...]`` stacks for the hybrid): views of the cast
    stacks, or under an FSDP gather context (``models.fsdp``) the layer's
    weights gathered at each call.  A caller drops a layer before it takes
    the next, so one layer is gathered at a time."""
    g = FS.active()
    if g is not None:
        return g.layers(params["layers"], compute_dtype)
    views = _unstack(cast_params(params["layers"], compute_dtype))
    return views.__getitem__


def _shared(params: Params, compute_dtype: torch.dtype) -> Params:
    """The hybrid's shared block in ``compute_dtype`` (gathered once a step
    under an FSDP gather context)."""
    return FS.top_tree(params["shared"], compute_dtype)


def _final_norm(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    return L.norm(cfg, x, FS.top(params.get("final_norm")))


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embed_tokens(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    table = FS.top(params["embed"], dtype).to(dtype)
    if AS.split("btv"):
        return AS.embed_lookup(table, tokens)
    return table[tokens.long()]


def input_embeddings(
    cfg: ModelConfig, params: Params, inputs: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """int tokens [B, S] through the embedding table, or (``embed_inputs``
    configs) precomputed embeddings [B, S, d] cast to ``dtype``.  Float
    inputs to any other config raise, as the reference's assert does."""
    if not inputs.is_floating_point():
        return embed_tokens(cfg, params, inputs, dtype)
    if not cfg.embed_inputs:
        raise ValueError(f"{cfg.name} does not take embedding inputs")
    return inputs.to(dtype)


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits ``[.., V]``, or this rank's columns ``[.., V/m]`` when the
    vocab splits over ``model`` (a tied table: its local rows,
    transposed)."""
    head = (FS.top(params["embed"], x.dtype).T if cfg.tie_embeddings
            else FS.top(params["lm_head"], x.dtype))
    return L.tp_entry(x, "btv") @ head.to(x.dtype)


# ---------------------------------------------------------------------------
# Forward (train / logits over the full sequence) and loss
# ---------------------------------------------------------------------------

#: remat policies: keep every activation, save only the projection
#: matmuls' outputs, or recompute each layer in the backward
REMAT_POLICIES = ("none", "dots", "full")
#: the ops whose outputs "dots" saves: matrix products with no batch dims
#: (the projections and the MoE router; attention's batched products, the
#: kernels and the experts' ``bmm``s, whose expert dimension is a batch
#: dimension, are recomputed), as
#: ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` does
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def _depth(cfg: ModelConfig) -> int:
    """Entries of the ``[L, ...]`` stacks: layers, or the hybrid's cycles."""
    return cfg.num_layers // cfg.shared_attn_every if cfg.family == "hybrid" else cfg.num_layers


def _unstack(stacked: Params) -> list:
    """[L, ...] leaves -> one tree per layer, as views whose backward stacks
    the layers' gradients once (``torch.unbind``)."""
    if isinstance(stacked, dict):
        per_key = {k: _unstack(v) for k, v in stacked.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(stacked, 0))


def _ffn(cfg: ModelConfig, p: Params, h: torch.Tensor) -> tuple:
    """The layer's MLP or MoE block: ``(y, moe_aux, moe_dropped)``, the last
    two None for the dense family (only the training forward reads them)."""
    if cfg.family == "moe":
        return MOE.moe_block(cfg, p, h)
    return L.mlp_block(p, h), None, None


def _dense_layer(cfg: ModelConfig, p: Params, x: torch.Tensor, impl: str) -> tuple:
    """One attention layer over the full sequence: ``(x, moe_aux,
    moe_dropped)`` as ``_ffn``."""
    h = L.norm(cfg, x, p.get("ln1"))
    x = x + L.attention_block(cfg, p["attn"], h, impl=impl)
    h = L.norm(cfg, x, p.get("ln2"))
    y, aux, dropped = _ffn(cfg, p["ffn"], h)
    return x + y, aux, dropped


def _ssm_layer(cfg: ModelConfig, p: Params, x: torch.Tensor, impl: str) -> tuple:
    """One Mamba1 layer over the full sequence (the scan under ``impl``):
    ``(x, None, None)`` as ``_dense_layer``."""
    h = L.norm(cfg, x, p.get("ln"))
    return x + SSM.mamba1_block(cfg, p["mixer"], h, impl), None, None


def _hybrid_cycle(
    cfg: ModelConfig, shared: Params, cyc: Params, x: torch.Tensor, impl: str
) -> tuple:
    """One hybrid cycle over the full sequence: the shared attention + MLP
    block (a dense layer), then the cycle's ``shared_attn_every`` Mamba2
    layers (``cyc``: their ``[every, ...]`` stacks).  Returns ``(x, None,
    None)`` as ``_dense_layer``."""
    x = _dense_layer(cfg, shared, x, impl)[0]
    for lp in _unstack(cyc):
        h = L.norm(cfg, x, lp.get("ln"))
        x = x + SSM.mamba2_block(cfg, lp["mixer"], h)
    return x, None, None


def forward(
    cfg: ModelConfig,
    params: Params,
    inputs: torch.Tensor,
    *,
    impl: str = "auto",
    remat_policy: str = "none",
    compute_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, dict]:
    """inputs: int tokens [B, S], or embeddings [B, S, d] for an
    ``embed_inputs`` config (``input_embeddings``).  Returns ``(logits
    [B, S, V], metrics)``.

    fp32 weights with ``ndim > 1`` are cast to ``compute_dtype`` inside the
    forward (differentiably, so their gradients arrive in fp32).
    ``remat_policy="full"`` recomputes each layer in the backward
    (``torch.utils.checkpoint``) instead of keeping its activations;
    ``"dots"`` keeps only the outputs of its projection matmuls and
    recomputes the rest (norms, RoPE, attention, activations, the experts'
    batched products).  The hybrid's unit of remat is the cycle (the shared
    block and its Mamba2 layers), as the reference's.  Mamba1's scan runs
    the scan kernel and its backward kernel on CUDA (``impl``).
    ``metrics`` holds ``moe_aux`` and ``moe_dropped``, the MoE family's mean
    over layers (zero for the other families)."""
    _require_family(cfg)
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    x = input_embeddings(cfg, params, inputs, compute_dtype)
    if cfg.family == "hybrid":
        shared = _shared(params, compute_dtype)
        body = lambda cfg_, lp, x_, impl_: _hybrid_cycle(cfg_, shared, lp, x_, impl_)
    elif cfg.family == "ssm":
        body = _ssm_layer
    else:
        body = _dense_layer
    layer_at = _layer_access(params, compute_dtype)
    auxs, drops = [], []
    for i in range(_depth(cfg)):
        # the layer is taken inside its checkpointed region, so a gathered
        # layer is gathered again by the recompute rather than kept
        run = lambda x_, i=i: body(cfg, layer_at(i), x_, impl)
        # the step draws no random numbers, and a captured step may not
        # save and restore the CUDA generator's state
        if remat_policy == "full":
            x, aux, dropped = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
        elif remat_policy == "dots":
            x, aux, dropped = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False,
                                         context_fn=_dots_context)
        else:
            x, aux, dropped = run(x)
        auxs.append(aux)
        drops.append(dropped)
    x = _final_norm(cfg, params, x)
    if cfg.family == "moe":
        metrics = {"moe_aux": torch.stack(auxs).mean(),
                   "moe_dropped": torch.stack(drops).mean()}
    else:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        metrics = {"moe_aux": zero, "moe_dropped": zero}
    return unembed(cfg, params, x), metrics


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
    """Mean next-token cross-entropy over fp32 logits plus
    ``moe_aux_weight`` times the MoE aux loss (zero for the dense family).
    Returns ``(loss, metrics)`` with ``metrics`` holding ``ce``, ``loss``,
    ``moe_aux`` and ``moe_dropped``."""
    logits, metrics = forward(
        cfg, params, inputs, impl=impl, remat_policy=remat_policy,
        compute_dtype=compute_dtype,
    )
    logits = logits.float()
    if AS.split("btv"):
        logz, gold = AS.vocab_logsumexp(logits), AS.vocab_gold(logits, labels)
    else:
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
    """Dense decode cache with ``index`` [B] int32 (the reference starts from
    a scalar that its engine replaces with a [B] vector).  Dense and MoE:
    ``layers.k/v`` are [L, B, S, kvH, hd] rows per slot.  Mamba1:
    ``layers.conv`` [L, B, conv - 1, d_inner] in ``dtype`` and ``layers.h``
    [L, B, d_inner, ssm_state] fp32 (``max_seq`` unused).  Hybrid:
    ``layers.mamba`` holds ``mamba2_init_state``'s leaves stacked
    [n_cyc, every, B, ...] (the batch on axis 2), ``layers.shared_k`` /
    ``shared_v`` the shared block's rows [n_cyc, B, S, kvH, hd]."""
    _require_family(cfg)
    l = cfg.num_layers
    if cfg.family == "ssm":
        st = SSM.mamba1_init_state(cfg, batch, dtype, device)
        layers = {k: v[None].expand(l, *v.shape).contiguous() for k, v in st.items()}
    elif cfg.family == "hybrid":
        n_cyc, every = l // cfg.shared_attn_every, cfg.shared_attn_every
        st = SSM.mamba2_init_state(cfg, batch, dtype, device)
        shape = (n_cyc, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        layers = {
            "mamba": {k: v[None, None].expand(n_cyc, every, *v.shape).contiguous()
                      for k, v in st.items()},
            "shared_k": torch.zeros(shape, dtype=dtype, device=device),
            "shared_v": torch.zeros(shape, dtype=dtype, device=device),
        }
    else:
        shape = (l, batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        layers = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
    return {
        "index": torch.zeros((batch,), dtype=torch.int32, device=device),
        "layers": layers,
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
    _require_attention(cfg)
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
    dense cache (Mamba1: its new conv and SSM state; hybrid: each cycle's
    shared-block K/V row and its layers' Mamba2 state) in place, and the
    returned cache is a new dict whose ``index`` is advanced by one.  On a
    model axis the logits are this rank's vocab columns.

    A recurrent state in an 8-bit float type (a prefill with an fp8
    ``cache_dtype``) raises ``TypeError``, as the reference does: its
    ``causal_conv_step`` concatenates the state with the new input, and JAX
    promotes no 8-bit float implicitly."""
    _require_family(cfg)
    states = chunk_recurrent_states(cfg, cache["layers"])
    if states is not None and any(t.dtype in L.FP8_DTYPES for t in tree_leaves(states)):
        raise TypeError(
            f"{cfg.name}: a recurrent state in an 8-bit float type does not decode (the "
            "reference's causal_conv_step concatenates it with a wider input, a "
            "promotion JAX refuses)")
    x = embed_tokens(cfg, params, tokens, compute_dtype)[:, None, :]
    idx = cache["index"]
    layer_at = _layer_access(params, compute_dtype)
    if cfg.family == "ssm":
        conv_all, h_all = cache["layers"]["conv"], cache["layers"]["h"]
        for i in range(cfg.num_layers):
            lp = layer_at(i)
            h = L.norm(cfg, x, lp.get("ln"))
            y, st = SSM.mamba1_step(
                cfg, lp["mixer"], h[:, 0], {"conv": conv_all[i], "h": h_all[i]}
            )
            conv_all[i] = st["conv"]
            h_all[i] = st["h"]
            x = x + y[:, None]
            del lp  # before the next layer is taken (gathered)
    elif cfg.family == "hybrid":
        shared = _shared(params, compute_dtype)
        mamba = cache["layers"]["mamba"]
        k_all, v_all = cache["layers"]["shared_k"], cache["layers"]["shared_v"]
        every = cfg.shared_attn_every
        for c in range(cfg.num_layers // every):
            h = L.norm(cfg, x, shared.get("ln1"))
            y, _ = L.attention_decode(
                cfg, shared["attn"], h, (k_all[c], v_all[c]), idx, impl=attn_impl
            )
            x = x + y
            h = L.norm(cfg, x, shared.get("ln2"))
            x = x + L.mlp_block(shared["ffn"], h)
            cyc = layer_at(c)
            for j in range(every):
                lp = _layer(cyc, j)
                h = L.norm(cfg, x, lp.get("ln"))
                y, st = SSM.mamba2_step(cfg, lp["mixer"], h[:, 0],
                                        {k: v[c, j] for k, v in mamba.items()})
                for k, v in st.items():
                    mamba[k][c, j] = v
                x = x + y[:, None]
            del cyc, lp
    else:
        bt = cache.get("block_tables")  # None: the dense layout
        k_all, v_all = cache["layers"]["k"], cache["layers"]["v"]
        plan = {}  # the paged K/V writes' destinations, shared by the layers
        for i in range(cfg.num_layers):
            lp = layer_at(i)
            h = L.norm(cfg, x, lp.get("ln1"))
            if bt is None:
                y, _ = L.attention_decode(
                    cfg, lp["attn"], h, (k_all[i], v_all[i]), idx, impl=attn_impl
                )
            else:
                y, _ = L.attention_decode_paged(
                    cfg, lp["attn"], h, (k_all[i], v_all[i]), bt, idx,
                    impl=attn_impl, plan=plan,
                )
            x = x + y
            h = L.norm(cfg, x, lp.get("ln2"))
            x = x + _ffn(cfg, lp["ffn"], h)[0]
            del lp
    x = _final_norm(cfg, params, x)
    logits = unembed(cfg, params, x)[:, 0]
    return logits, dict(cache, index=idx + 1)


# ---------------------------------------------------------------------------
# Chunk-verify decode (the speculative target pass)
# ---------------------------------------------------------------------------


def recurrent_state_batch_axis(cfg: ModelConfig) -> int:
    """The batch axis of the recurrent state's leaves
    (``chunk_recurrent_states``): 1 for Mamba1's ``[L, B, ...]``, 2 for the
    hybrid's ``[n_cyc, every, B, ...]``.  The per-step stacks of
    ``decode_chunk`` and ``draft_propose`` carry one more leading step
    axis."""
    return 2 if cfg.family == "hybrid" else 1


def chunk_recurrent_states(cfg: ModelConfig, layers: Params) -> Optional[Params]:
    """The rollback-relevant slice of a cache's ``layers``, as views of its
    own tensors (the speculative round writes the rolled-back state into
    them in place): the conv and SSM state of the Mamba1 family, the
    hybrid's ``mamba`` state, ``None`` for the attention families, whose
    rollback is an index rewind."""
    _require_family(cfg)
    if cfg.family == "ssm":
        return layers
    if cfg.family == "hybrid":
        return layers["mamba"]
    return None


def decode_chunk(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    cache: Params,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
    logits_at: Optional[int] = None,
    anc: Optional[torch.Tensor] = None,
    depths: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Params, Optional[Params]]:
    """Score a T = gamma + 1 speculative chunk.  tokens: [B, T] int32, the
    current token plus gamma draft tokens.  Returns ``(logits [B, T, V],
    cache, chunk_states)`` with the returned cache's ``index`` advanced by
    T.

    The attention families score the chunk in ONE pass over the paged or
    dense cache: every layer writes the chunk's K/V in place (paged:
    ``attention_verify_paged``; dense: ``attention_verify``), and
    ``chunk_states`` is ``None`` (their rollback is an index rewind).  The
    recurrent families (Mamba1, hybrid) cannot score the steps in parallel:
    they run ``decode_step`` T times, writing the state in place, and
    ``chunk_states`` holds a copy of the recurrent state
    (``chunk_recurrent_states``) after each step, stacked on a new leading
    axis of T, from which acceptance selects each slot's state
    (``spec.rollback``).

    ``logits_at`` (an int or a 0-d integer tensor, clamped into [0, T - 1])
    restricts the unembedding to one chunk position: logits come back
    [B, 1, V] (the suffix prefill needs only its last real position).

    Tree mode (attention families only): ``anc`` [B, T] int32 ancestor
    bitmasks and ``depths`` [T] int32 node depths turn the rows into
    packed-tree nodes (node 0 = the current token) verified by the tree
    kernel."""
    if cfg.family in ("ssm", "hybrid"):
        if anc is not None:
            raise ValueError(
                f"tree verification needs an attention family, got {cfg.family!r}")
        return _recurrent_chunk(cfg, params, tokens, cache, compute_dtype, attn_impl,
                                logits_at)
    _require_attention(cfg)
    t = tokens.shape[1]
    x = embed_tokens(cfg, params, tokens, compute_dtype)  # [B, T, d]
    idx = cache["index"]
    bt = cache.get("block_tables")  # None: the dense layout
    layers = cast_params(params["layers"], compute_dtype)
    k_all, v_all = cache["layers"]["k"], cache["layers"]["v"]
    plan = {}  # the paged K/V writes' destinations, shared by the layers
    for i in range(cfg.num_layers):
        lp = _layer(layers, i)
        h = L.norm(cfg, x, lp.get("ln1"))
        if bt is None:
            y, _ = L.attention_verify(
                cfg, lp["attn"], h, (k_all[i], v_all[i]), idx,
                impl=attn_impl, anc=anc, depths=depths,
            )
        else:
            y, _ = L.attention_verify_paged(
                cfg, lp["attn"], h, (k_all[i], v_all[i]), bt, idx,
                impl=attn_impl, anc=anc, depths=depths, plan=plan,
            )
        x = x + y
        h = L.norm(cfg, x, lp.get("ln2"))
        x = x + _ffn(cfg, lp["ffn"], h)[0]
    x = _final_norm(cfg, params, x)
    if logits_at is not None:
        x = x.index_select(1, _position(logits_at, t, x.device))
    return unembed(cfg, params, x), dict(cache, index=idx + t), None


def _position(j, t: int, device) -> torch.Tensor:
    """``j`` (an int or a 0-d integer tensor) clamped into [0, t - 1], as a
    [1] index tensor: a gather in place of a slice, so a device position
    costs no host sync."""
    return L.device_scalar(j, device).long().clamp(0, t - 1).reshape(1)


def _recurrent_chunk(cfg, params, tokens, cache, compute_dtype, attn_impl, logits_at):
    """``decode_chunk`` of a recurrent family: T decode steps, the state
    copied after each into a [T, ...] stack (``decode_step`` overwrites it
    in place)."""
    t = tokens.shape[1]
    live = chunk_recurrent_states(cfg, cache["layers"])
    states = tree_map(lambda v: v.new_empty((t, *v.shape)), live)
    logits = []
    for j in range(t):
        lj, cache = decode_step(cfg, params, tokens[:, j], cache,
                                compute_dtype=compute_dtype, attn_impl=attn_impl)
        logits.append(lj)
        for stack, v in zip(tree_leaves(states), tree_leaves(live)):
            stack[j].copy_(v)
    logits = torch.stack(logits, dim=1)
    if logits_at is not None:
        logits = logits.index_select(1, _position(logits_at, t, logits.device))
    return logits, cache, states


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
    _require_attention(cfg)
    x = embed_tokens(cfg, params, tokens, compute_dtype)  # [B, C, d]
    idx = cache["index"]
    lens = chunk_lens.to(torch.int32)
    bt = cache.get("block_tables")  # None: the dense layout
    layers = cast_params(params["layers"], compute_dtype)
    k_all, v_all = cache["layers"]["k"], cache["layers"]["v"]
    plan = {}  # the paged K/V writes' destinations, shared by the layers
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
                impl=attn_impl, plan=plan,
            )
        x = x + y
        h = L.norm(cfg, x, lp.get("ln2"))
        x = x + _ffn(cfg, lp["ffn"], h)[0]
    new_cache = dict(cache, index=idx + lens)
    if not need_logits:
        return torch.zeros_like(lens), new_cache
    x = _final_norm(cfg, params, x)
    pos = torch.clamp(lens - 1, min=0).long()
    last = x[torch.arange(x.shape[0], device=x.device), pos][:, None]  # [B, 1, d]
    logits = unembed(cfg, params, last)[:, 0]
    return torch.argmax(logits, dim=-1).to(torch.int32), new_cache


# ---------------------------------------------------------------------------
# Monolithic prefill: forward + cache construction
# ---------------------------------------------------------------------------


def prefill(
    cfg: ModelConfig,
    params: Params,
    inputs: torch.Tensor,
    max_seq: int,
    *,
    impl: str = "auto",
    compute_dtype: torch.dtype = torch.bfloat16,
    cache_dtype: Optional[torch.dtype] = None,
    length=None,
) -> tuple[torch.Tensor, Params]:
    """Full-sequence prefill.  inputs: [B, S] int tokens, or [B, S, d]
    embeddings for an ``embed_inputs`` config (``input_embeddings``).  Returns
    ``(last-position logits [B, V], cache)`` with the cache in
    ``cache_dtype`` (default ``compute_dtype``): dense and MoE, K/V
    [L, B, max_seq, kvH, hd] zero-padded past S; Mamba1, the conv and SSM
    state after the prompt; hybrid, both: each cycle's shared-block K/V and
    its layers' Mamba2 state (``init_cache``'s layout).

    ``length`` (an int or a 0-d integer tensor, which costs no host sync)
    marks the true prompt length when ``inputs`` is zero-padded to a bucket:
    logits are taken at ``length - 1`` and ``index`` is ``length``.
    Dense pad positions only give K/V past the index, which decode overwrites
    before reading; SSM pad steps get dt = 0, so the state is exactly the
    unpadded prompt's (``SSM.dt_mask``).  The attention core is
    ``ops.attention`` (the flash kernel on CUDA; one launch per layer, or
    per hybrid cycle), the Mamba1 scan ``ops.ssm_scan_chunk`` (the scan
    kernel on CUDA), under ``impl``; the Mamba2 SSD is plain PyTorch.

    The hybrid prefills whole 64-step SSD chunks: the prompt is padded with
    token 0 (dt-masked past ``length``, its K/V dropped past S), so its
    logits and state do not depend on the bucket it came in, bit for bit (an
    elementwise op's result can depend on its tensor's length, through the
    CPU's vector tail).  A bucket of 64 or more tokens runs as it is."""
    _require_family(cfg)
    cache_dtype = cache_dtype or compute_dtype
    b, s = inputs.shape[:2]
    if cfg.family == "hybrid":
        length = s if length is None else length
        run = -(-s // SSM.DEFAULT_CHUNK) * SSM.DEFAULT_CHUNK
        inputs = torch.nn.functional.pad(inputs, (0, run - s))
    else:
        run = s
    x = input_embeddings(cfg, params, inputs, compute_dtype)
    layer_at = _layer_access(params, compute_dtype)
    positions = torch.arange(run, device=x.device).expand(b, run)

    def pad_kv(t: list) -> torch.Tensor:
        kv = L.to_cache(torch.stack(t)[:, :, :s], cache_dtype)  # [L or n_cyc, B, S, kvH, hd]
        pad = torch.nn.functional.pad(L.cache_bytes(kv), (0, 0, 0, 0, 0, max_seq - s))
        return pad.view(cache_dtype)

    if cfg.family == "ssm":
        conv, hs = [], []
        for i in range(cfg.num_layers):
            lp = layer_at(i)
            h = L.norm(cfg, x, lp.get("ln"))
            y, st = SSM.mamba1_with_state(cfg, lp["mixer"], h, impl, length=length)
            x = x + y
            conv.append(st["conv"])
            hs.append(st["h"])
            del lp
        new_layers = {
            "conv": L.to_cache(torch.stack(conv), cache_dtype),
            "h": torch.stack(hs).float(),
        }
    elif cfg.family == "hybrid":
        shared = _shared(params, compute_dtype)
        every = cfg.shared_attn_every
        n_cyc = cfg.num_layers // every
        ks, vs, states = [], [], []
        for c in range(n_cyc):
            h = L.norm(cfg, x, shared.get("ln1"))
            y, k, v = _attn_prefill(cfg, shared["attn"], h, positions, impl)
            x = x + y
            h = L.norm(cfg, x, shared.get("ln2"))
            x = x + L.mlp_block(shared["ffn"], h)
            ks.append(k)
            vs.append(v)
            cyc = layer_at(c)
            for j in range(every):
                lp = _layer(cyc, j)
                h = L.norm(cfg, x, lp.get("ln"))
                y, st = SSM.mamba2_with_state(cfg, lp["mixer"], h, length=length)
                x = x + y
                states.append(st)
            del cyc, lp
        mamba = {}
        for name in states[0]:
            t = torch.stack([st[name] for st in states])
            t = t.reshape(n_cyc, every, *t.shape[1:])
            mamba[name] = t.float() if name == "h" else L.to_cache(t, cache_dtype)
        new_layers = {"mamba": mamba, "shared_k": pad_kv(ks), "shared_v": pad_kv(vs)}
    else:
        ks, vs = [], []
        for i in range(cfg.num_layers):
            lp = layer_at(i)
            h = L.norm(cfg, x, lp.get("ln1"))
            y, k, v = _attn_prefill(cfg, lp["attn"], h, positions, impl)
            x = x + y
            h = L.norm(cfg, x, lp.get("ln2"))
            x = x + _ffn(cfg, lp["ffn"], h)[0]
            ks.append(k)
            vs.append(v)
            del lp
        new_layers = {"k": pad_kv(ks), "v": pad_kv(vs)}
    x = _final_norm(cfg, params, x)
    n = L.device_scalar(s if length is None else length, x.device)
    # the logits of a position of the prompt
    logits = unembed(cfg, params, x.index_select(1, _position(n - 1, s, x.device)))[:, 0]
    return logits, {"index": n.to(torch.int32).clone(), "layers": new_layers}


def _attn_prefill(cfg: ModelConfig, p: Params, h: torch.Tensor,
                  positions: torch.Tensor, impl: str) -> tuple:
    """Causal attention over the prompt through ``ops.attention``: ``(y, k,
    v)``, the block's output and the K/V it caches (every KV head of this
    rank's ``wk``, whichever its q heads read)."""
    q, k, v = L._project_qkv(cfg, p, L.tp_entry(h, "bthd"), positions)
    out = ops.attention(q, *L._local_kv(cfg, p, k, v), causal=True, impl=impl)
    return L._out_proj(cfg, p, out), k, v


def prefill_into_slot(
    cfg: ModelConfig,
    params: Params,
    inputs: torch.Tensor,
    length,
    slot,
    cache: Params,
    *,
    max_seq: int,
    impl: str = "auto",
    compute_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, Params]:
    """Prefill one bucket-padded prompt and write its K/V (or SSM state)
    into the batch cache's row ``slot``, in place (the whole row, as the
    reference's ``dynamic_update_index_in_dim``), and set ``index[slot] =
    length``.  The batch axis is 1 of every leaf but the hybrid's Mamba2
    state, whose leaves are [n_cyc, every, B, ...].  inputs: [1, S_bucket]
    int32, or [1, S_bucket, d] embeddings (``prefill``).  ``length`` and
    ``slot`` are ints or 0-d integer tensors: the writes are index copies,
    so device values cost no host sync.  Returns ``(first generated token
    [] int32 on the device, cache)``."""
    layers = cache["layers"]
    cache_dtype = (layers["shared_k"] if cfg.family == "hybrid"
                   else next(iter(layers.values()))).dtype
    logits, new = prefill(
        cfg, params, inputs, max_seq, impl=impl, compute_dtype=compute_dtype,
        cache_dtype=cache_dtype, length=length,
    )
    tok = torch.argmax(logits[0]).to(torch.int32)
    row = _slot_index(slot, logits.device)
    for name, leaf in layers.items():
        if name == "mamba":
            for k, t in leaf.items():
                _write_rows(t, 2, row, new["layers"]["mamba"][k][:, :, :1])
        else:
            _write_rows(leaf, 1, row, new["layers"][name][:, :1])
    _write_rows(cache["index"], 0, row, new["index"].reshape(1))
    return tok, cache


def _slot_index(slot, device) -> torch.Tensor:
    """``slot`` (an int or a 0-d integer tensor) as a [1] long index."""
    return L.device_scalar(slot, device).long().reshape(1)


def _write_rows(dst: torch.Tensor, dim: int, rows: torch.Tensor, src: torch.Tensor) -> None:
    """``dst``'s entries ``rows`` along ``dim`` set to ``src``, in place (an
    index copy of the codes: an 8-bit cache moves bit for bit)."""
    L.cache_bytes(dst).index_copy_(dim, rows, L.cache_bytes(src.to(dst.dtype)))


def prefill_into_slot_paged(
    cfg: ModelConfig,
    params: Params,
    inputs: torch.Tensor,
    length,
    slot,
    cache: Params,
    *,
    impl: str = "auto",
    compute_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, Params]:
    """Cold-path prefill straight into the paged pool: ``prefill`` over the
    [1, S_bucket] prompt (tokens, or [1, S_bucket, d] embeddings) against a
    bucket-sized cache, then the bucket's K/V scattered page by page into
    the pages of the slot's block-table row, in
    place.  The bucket must be page-aligned.  Pad positions past ``length``
    land on the slot's last page past the index (overwritten before read) or
    on unallocated table entries, which hold the sentinel page.  ``length``
    and ``slot``: ints or 0-d integer tensors, as ``prefill_into_slot``.
    Returns ``(first generated token [] int32 on the device, cache)``."""
    _require_attention(cfg)
    k_pool = cache["layers"]["k"]  # [L, P, page, kvH, hd]
    l, _, page, kvh, hd = k_pool.shape
    sb = inputs.shape[1]
    if sb % page:
        raise ValueError(f"prefill bucket {sb} not page-aligned ({page})")
    nbp = sb // page
    logits, new = prefill(
        cfg, params, inputs, sb, impl=impl, compute_dtype=compute_dtype,
        cache_dtype=k_pool.dtype, length=length,
    )
    tok = torch.argmax(logits[0]).to(torch.int32)
    row = _slot_index(slot, logits.device)
    pages = cache["block_tables"].index_select(0, row)[0, :nbp].long()
    for name in ("k", "v"):
        pool = cache["layers"][name]
        pool[:, pages] = new["layers"][name][:, 0].reshape(l, nbp, page, kvh, hd)
    _write_rows(cache["index"], 0, row, new["index"].reshape(1))
    return tok, cache


def prefill_suffix_into_slot(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    suffix_len,
    shared_len,
    slot,
    cache: Params,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    attn_impl: str = "auto",
) -> tuple[torch.Tensor, Params]:
    """Prefix-hit prefill: score only the prompt suffix against the shared
    prefix pages already in the pool.  tokens: [1, T_bucket] int32, the
    suffix zero-padded to a bucket; ``shared_len`` tokens (whole pages) come
    from the radix cache; the slot's block-table row maps them and its
    fresh suffix pages.  ``decode_chunk`` on a one-row view of the paged
    cache does the work (the paged verify kernel, ``lengths = shared +
    T_bucket`` unclamped), writing the suffix K/V into the slot's pages in
    place; only row ``suffix_len - 1``'s logits are taken.  The lengths and
    ``slot`` are ints or 0-d integer tensors, as ``prefill_into_slot``.
    Returns ``(first generated token [] int32 on the device, cache)``."""
    dev = tokens.device
    row = _slot_index(slot, dev)
    shared = L.device_scalar(shared_len, dev).to(torch.int32).reshape(1)
    suffix = L.device_scalar(suffix_len, dev).to(torch.int32).reshape(1)
    view = {
        "index": shared,
        "block_tables": cache["block_tables"].index_select(0, row),
        "layers": cache["layers"],
    }
    logits, _, _ = decode_chunk(
        cfg, params, tokens, view, compute_dtype=compute_dtype,
        attn_impl=attn_impl, logits_at=suffix - 1,
    )
    tok = torch.argmax(logits[0, 0]).to(torch.int32)
    _write_rows(cache["index"], 0, row, shared + suffix)
    return tok, cache
