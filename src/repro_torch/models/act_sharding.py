"""Activation sharding over the mesh's ``model`` axis (counterpart of
``repro.models.act_sharding``).

The reference's model code is mesh-agnostic: its step builders activate a
context with the activation specs, and ``shard(x, kind)`` pins a
block-boundary tensor to its spec, from which GSPMD derives the
collectives.  The port has no GSPMD.  Its model code runs on this rank's
blocks of the weights (the shards ``runtime.sharding.param_specs`` gives)
and issues the collectives those specs imply itself, through the hooks
below, each over the ``model`` group of the context's ``Mesh`` (so
``Mesh.collectives`` counts them):

  * Megatron pairs (``copy_to_model`` at a tensor-parallel region's entry:
    identity forward, all-reduce backward; ``reduce_from_model`` after a
    row-parallel product: all-reduce forward, identity backward), around
    attention when its q heads split (``split("bthd")``), the MLP when its
    hidden dim splits (``"btf"``), the MoE block when its experts split
    (``"ecd"``) and the Mamba1 / Mamba2 mixers when ``d_inner`` splits
    (``"bti"``)
  * ``all_reduce_model``, a sum over the split ``d_inner`` that split code
    consumes again (Mamba1's ``x_proj`` output, Mamba2's gated norm's sum
    of squares): all-reduce forward AND backward
  * the vocab-parallel embedding lookup, logsumexp, gold logit and argmax
    (``"btv"``)
  * the sequence-parallel decode (the dense cache's sequence dim split over
    ``cache_seq``'s axes): the partials' all-gather

Outside a context, or at a model axis of 1 (and on the ``dp256`` layout,
whose plan folds ``model`` into the data axes), every hook is the identity
and issues no collective.  ``shard(x, kind)`` is the identity too: the
port's tensors are already this rank's blocks.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

_ACTIVE: Optional["Context"] = None

MODEL = ("model",)


class Context:
    """The active mesh, its activation specs (``runtime.sharding``
    ``activation_specs``) and the decode cache's sequence axes."""

    def __init__(self, mesh, specs: dict, cache_seq=None):
        self.mesh, self.specs = mesh, specs
        self.model = mesh.shape.get("model", 1) if any(
            _model_split(kind, spec) for kind, spec in specs.items()) else 1
        self.rank = mesh.coordinate.get("model", 0) if self.model > 1 else 0
        self.seq_axes = mesh.axes(cache_seq) if cache_seq is not None else ()
        if self.seq_axes and mesh.size(self.seq_axes) == 1:
            self.seq_axes = ()
        batch = specs["btd"][0] if "btd" in specs else None
        self.batch_axes = mesh.axes(batch) if mesh.size(mesh.axes(batch)) > 1 else ()


def _names(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def _model_split(kind: str, spec) -> bool:
    """Whether ``spec`` splits a non-batch dim of ``kind`` over ``model``
    (a leading ``b`` is the batch, which rides ``model`` on ``dp256``)."""
    dims = spec[1:] if kind.startswith("b") else spec
    return any("model" in _names(e) for e in dims)


@contextlib.contextmanager
def activation_sharding(mesh, specs: dict, *, cache_seq=None):
    """Run model code on ``mesh``'s blocks under ``specs`` (the kind ->
    spec table of ``runtime.sharding.activation_specs``); ``cache_seq`` is
    the dense cache's sequence entry of ``cache_specs`` (the decode's
    sequence-parallel axes)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = Context(mesh, specs, cache_seq)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def shard(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The reference's anchor: ``x`` as it is (already this rank's block)."""
    return x


def model_size() -> int:
    return _ACTIVE.model if _ACTIVE is not None else 1


def model_rank() -> int:
    return _ACTIVE.rank if _ACTIVE is not None else 0


def split(kind: str) -> bool:
    """Whether the active context splits ``kind``'s tensor over a model
    axis larger than 1."""
    ctx = _ACTIVE
    if ctx is None or ctx.model == 1:
        return False
    return _model_split(kind, ctx.specs.get(kind, ()))


# ---------------------------------------------------------------------------
# Megatron pairs
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over ``model`` backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(memory_format=torch.contiguous_format), MODEL), None


class _ReduceFromModel(torch.autograd.Function):
    """Summed over ``model`` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone(memory_format=torch.contiguous_format), MODEL)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """A tensor-parallel region's entry: ``x`` (replicated over ``model``)
    as it is; its gradient, a partial sum on each rank, is all-reduced."""
    if model_size() == 1:
        return x
    return _CopyToModel.apply(x, _ACTIVE.mesh)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """After a row-parallel product: the ranks' partial sums all-reduced
    over ``model``; the gradient passes through."""
    if model_size() == 1:
        return x
    return _ReduceFromModel.apply(x, _ACTIVE.mesh)


def all_reduce_model(x: torch.Tensor) -> torch.Tensor:
    """The ranks' partial sums of ``x`` all-reduced over ``model``, for a
    consumer that is itself split: its gradient, on each rank the part its
    own block of the consumer gives, is all-reduced too
    (``copy_to_model(reduce_from_model(x))``; ``reduce_from_model`` alone
    would leave each rank its own part of it)."""
    return copy_to_model(reduce_from_model(x))


def once_over_model(x: torch.Tensor) -> torch.Tensor:
    """``x``, computed identically on every model rank, with its gradient
    kept on model rank 0 only (detached elsewhere), so that a sum over
    ``model`` counts it once."""
    return x if model_rank() == 0 else x.detach()


def all_gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' blocks of ``x`` along ``dim`` (no gradient)."""
    return _ACTIVE.mesh.all_gather(x, MODEL, dim).contiguous()


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """A batch split over the data axes, whole: the ranks' rows of ``x``
    ``[B/n, ...]`` all-gathered in their order (no gradient; ``x`` itself
    when the batch does not split)."""
    ctx = _ACTIVE
    if ctx is None or not ctx.batch_axes:
        return x
    return ctx.mesh.all_gather(x, ctx.batch_axes, 0).contiguous()


def batch_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's ``n`` rows of a whole batch ``x`` (``gather_batch``'s
    inverse)."""
    ctx = _ACTIVE
    if ctx is None or not ctx.batch_axes:
        return x
    return x[ctx.mesh.index(ctx.batch_axes) * n:][:n]


# ---------------------------------------------------------------------------
# Vocab parallelism: this rank holds the rows / columns offset .. offset + V/m
# ---------------------------------------------------------------------------


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of a vocab-split table ``[V/m, d]`` for global token ids: each
    rank looks up the ids in its rows (zeros for the others), then one
    all-reduce over ``model``."""
    v_loc = table.shape[0]
    ids = tokens.long() - model_rank() * v_loc
    mine = (ids >= 0) & (ids < v_loc)
    rows = table[ids.clamp(0, v_loc - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return reduce_from_model(rows)


def vocab_logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the vocab from this rank's columns ``[.., V/m]``: the
    largest logit all-reduced by max (no gradient), then the sum of
    exponentials all-reduced."""
    peak = logits.detach().amax(dim=-1)
    _ACTIVE.mesh.all_reduce(peak, MODEL, op="max")
    total = reduce_from_model(torch.exp(logits - peak[..., None]).sum(-1))
    return peak + torch.log(total)


def vocab_gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The logit of each label from the rank whose columns hold it (a
    masked all-reduce)."""
    v_loc = logits.shape[-1]
    ids = labels.long() - model_rank() * v_loc
    mine = (ids >= 0) & (ids < v_loc)
    gold = torch.gather(logits, -1, ids.clamp(0, v_loc - 1)[..., None])[..., 0]
    return reduce_from_model(torch.where(mine, gold, torch.zeros_like(gold)))


def vocab_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Global argmax of vocab-split logits ``[B, V/m]``: each rank's largest
    value and its index, all-gathered; ties go to the lowest global index,
    as ``jnp.argmax``."""
    v_loc = logits.shape[-1]
    val, idx = torch.max(logits.float(), dim=-1)
    pair = torch.stack([val, (idx + model_rank() * v_loc).float()], dim=-1)  # [B, 2]
    every = all_gather_model(pair[None], 0)  # [m, B, 2]
    best = every[..., 0].amax(dim=0)
    first = (every[..., 0] == best).to(torch.int32).argmax(dim=0)  # lowest rank
    return every[..., 1].gather(0, first[None])[0].to(torch.int32)


# ---------------------------------------------------------------------------
# Sequence-parallel decode
# ---------------------------------------------------------------------------


def seq_parallel() -> bool:
    """Whether the active context splits the dense cache's sequence dim."""
    return _ACTIVE is not None and bool(_ACTIVE.seq_axes)


def seq_block() -> tuple[int, int]:
    """(this rank's block, the blocks) of the cache's sequence dim."""
    axes = _ACTIVE.seq_axes
    return _ACTIVE.mesh.index(axes), _ACTIVE.mesh.size(axes)


def gather_seq(t: torch.Tensor) -> torch.Tensor:
    """The sequence blocks' ``t`` ``[B, ...]`` stacked in block order as
    ``[B, n, ...]`` (contiguous: the merge kernel reads raw pointers)."""
    return _ACTIVE.mesh.all_gather(t[:, None], _ACTIVE.seq_axes, 1).contiguous()
