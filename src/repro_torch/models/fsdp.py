"""FSDP weights gathered one layer at a time.

Under FSDP (``TrainConfig.fsdp``, or the serve steps' FSDP weights) each
leaf the sharding rules split over a data axis lives on a rank as its
shard.  The step builders of ``runtime.step`` open a ``layer_gather``
context over the shards; inside it the model code
(``models.transformer``'s ``forward``, ``decode_step`` and ``prefill``)
takes each layer's weights from the context just before the layer runs
(``layers``), and the leaves outside the stacks where it uses them
(``top``: the embedding table, the LM head, the final norm; ``top_tree``:
the hybrid's shared block, once a step).  Outside a context both give the
leaves as they are.

A split leaf's layer ``i`` (the first dim of its ``[L, ...]`` stack: a
cycle of the hybrid) is all-gathered over the data axes of its split dims
and cast to the compute dtype after the gather.  Nothing gathered outlives
its use: a layer's weights are dropped when the layer returns, and while
autograd records, a ``saved_tensors_hooks`` pair packs a saved gathered
weight as its (leaf, layer) key and gathers it again when the backward
unpacks it, keeping one layer's weights at a time.  Under remat ``"full"``
/ ``"dots"`` the layer is gathered inside its checkpointed region, so the
recompute gathers it again.  The shared block stays for the step.

In the backward a gathered weight's gradient (fp32) is reduce-scattered
into the shard's block of its layer: at once for a layer leaf under one
microbatch; after the step's last microbatch for a leaf outside the stacks
(the tied table's gradient arrives twice) and for every leaf under
microbatches, each rank's sum over its microbatches first (FSDP's
``no_sync``).  The sums thus run in the whole-tree gather's order (its
reduce-scatter of the whole leaf after the microbatches), so the gradients
equal that step's wherever the collective's sum does not depend on the
buffer (two ranks).  ``grads`` hands them to the step.

``max_live_gathered_bytes`` is the most gathered bytes alive at once (the
storages the context made, counted until freed): one layer's weights plus
the leaves outside the stacks in use.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Optional

import torch

_ACTIVE: Optional["LayerGather"] = None


def active() -> Optional["LayerGather"]:
    return _ACTIVE


def top(t: Optional[torch.Tensor], dtype: Optional[torch.dtype] = None
        ) -> Optional[torch.Tensor]:
    """A leaf outside the stacks, gathered when the active context splits it
    and cast to ``dtype`` (given) after the gather; ``t`` as it is
    otherwise, ``None`` for ``None``."""
    if _ACTIVE is None or t is None or id(t) not in _ACTIVE.leaves:
        return t
    return _ACTIVE.full(t, None, dtype)


def top_tree(tree, dtype: torch.dtype):
    """The hybrid's shared block in ``dtype`` (``transformer.cast_params``'
    rule), its split leaves gathered once and kept for the step."""
    if isinstance(tree, dict):
        return {k: top_tree(v, dtype) for k, v in tree.items()}
    if _ACTIVE is None or id(tree) not in _ACTIVE.leaves:
        return _cast(tree, tree.ndim, dtype)
    return _ACTIVE.full(tree, None, dtype, resident=True)


def _cast(t: torch.Tensor, ndim: int, dtype: torch.dtype) -> torch.Tensor:
    """``transformer.cast_params``' rule for a tensor of a leaf of ``ndim``
    dims: fp32 leaves of ndim > 1 go to ``dtype``."""
    return t.to(dtype) if t.dtype == torch.float32 and ndim > 1 else t


class _Gather(torch.autograd.Function):
    """The gathered weight of ``key`` from this rank's ``shard``; its
    gradient goes to the context (``collect``), none to the shard."""

    @staticmethod
    def forward(ctx, shard, owner, key):
        ctx.owner, ctx.key = owner, key
        return owner.gather(key)

    @staticmethod
    def backward(ctx, g):
        ctx.owner.collect(ctx.key, g)
        return None, None, None


class _Packed:
    """A saved gathered weight: its key and its view of the storage."""

    __slots__ = ("key", "dtype", "size", "stride", "offset")

    def __init__(self, key, t: torch.Tensor):
        self.key, self.dtype = key, t.dtype
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()


class LayerGather:
    """The context's state: the split leaves (by identity and by index)
    with their split dims, the gathered storages alive, the gradients
    collected."""

    def __init__(self, mesh, leaves: list, splits: list, n_micro: int = 1):
        self.mesh, self.n_micro = mesh, max(1, n_micro)
        #: id(leaf) -> leaf index; leaf index -> (leaf, [(dim, axes)])
        self.leaves = {id(t): i for i, (t, s) in enumerate(zip(leaves, splits)) if s}
        self._split = {i: (t, s) for i, (t, s) in enumerate(zip(leaves, splits)) if s}
        self._live: dict = {}  # storage pointer -> key, for the pack hook
        self._resident: set = set()  # keys kept for the step (never packed)
        self._live_bytes = 0
        self.max_live_gathered_bytes = 0
        self._regathered: dict = {}  # the backward's (key, dtype) -> tensor
        self._group = None  # the layer (None: outside the stacks) regathered
        self._micro: dict = {}  # key -> this microbatch's fp32 gradient
        self._pending: dict = {}  # key -> the microbatches' sum, not reduced
        self._grads: dict = {}  # leaf index -> this rank's reduced gradient

    # -- gathering --------------------------------------------------------
    def gather(self, key) -> torch.Tensor:
        """Layer ``key[1]`` of leaf ``key[0]`` (the whole leaf for
        ``None``), all-gathered over its split dims: contiguous, in the
        leaf's dtype, counted."""
        leaf, split = self._split[key[0]]
        out, shift = leaf.detach(), 0
        if key[1] is not None:
            out, shift = out[key[1]], 1
        for dim, axes in split:
            out = self.mesh.all_gather(out, axes, dim - shift)
        return self._register(out.contiguous(), key)

    def _register(self, t: torch.Tensor, key) -> torch.Tensor:
        ptr = t.untyped_storage().data_ptr()
        if ptr in self._live:
            return t
        nbytes = t.untyped_storage().nbytes()
        self._live[ptr] = key
        self._live_bytes += nbytes
        self.max_live_gathered_bytes = max(self.max_live_gathered_bytes, self._live_bytes)
        weakref.finalize(t, self._freed, ptr, nbytes)
        return t

    def _freed(self, ptr: int, nbytes: int) -> None:
        self._live.pop(ptr, None)
        self._live_bytes -= nbytes

    def full(self, leaf: torch.Tensor, layer, dtype: Optional[torch.dtype],
             resident: bool = False) -> torch.Tensor:
        """The gathered ``leaf`` (its ``layer``, or the whole leaf for
        ``None``), cast to ``dtype`` by ``_cast``'s rule (kept for the step
        when ``resident``).  A forward's gather ends the backward's
        regathered layer (the next microbatch, or a recompute)."""
        self._regathered.clear()
        key = (self.leaves[id(leaf)], layer)
        if resident:
            self._resident.add(key)
        if torch.is_grad_enabled() and leaf.requires_grad:
            out = _Gather.apply(leaf, self, key)
        else:
            out = self.gather(key)
        return out if dtype is None else self._register(_cast(out, leaf.ndim, dtype), key)

    def layers(self, stacked, dtype: torch.dtype) -> Callable:
        """``i -> layer i`` of a tree of ``[L, ...]`` stacks in ``dtype``:
        split leaves gathered at each call, the others views of their
        stacks cast once here (``transformer.cast_params``' rule)."""
        flat = []

        def walk(tree, path):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    views = None if id(v) in self.leaves else torch.unbind(_cast(v, v.ndim, dtype))
                    flat.append((path + (k,), v, views))
        walk(stacked, ())

        def layer(i: int) -> dict:
            out: dict = {}
            for path, leaf, views in flat:
                node = out
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = views[i] if views is not None else self.full(leaf, i, dtype)
            return out
        return layer

    # -- the backward -----------------------------------------------------
    def pack(self, t: torch.Tensor):
        key = self._live.get(t.untyped_storage().data_ptr())
        return t if key is None or key in self._resident else _Packed(key, t)

    def unpack(self, p):
        if not isinstance(p, _Packed):
            return p
        if p.key[1] != self._group:  # another layer's weights: drop the last one's
            self._regathered.clear()
            self._group = p.key[1]
        base = self._regathered.get((p.key, p.dtype))
        if base is None:
            base = self._register(self.gather(p.key).to(p.dtype), p.key)
            self._regathered[(p.key, p.dtype)] = base
        return base.as_strided(p.size, p.stride, p.offset)

    def collect(self, key, g: torch.Tensor) -> None:
        g = g.float()
        if key[1] is not None and self.n_micro == 1:
            self._reduce(key, g)
        else:  # the uses of one microbatch summed first, as autograd sums them
            self._micro[key] = g if key not in self._micro else self._micro[key] + g

    def end_microbatch(self) -> None:
        """Add this microbatch's gradients to the step's sums (call after
        each microbatch's backward)."""
        for key, g in self._micro.items():
            self._pending[key] = g if key not in self._pending else self._pending[key] + g
        self._micro.clear()

    def _reduce(self, key, g: torch.Tensor) -> None:
        """``g`` reduce-scattered into this rank's block of leaf ``key[0]``
        (of its layer ``key[1]``)."""
        idx, layer = key
        leaf, split = self._split[idx]
        shift = 0 if layer is None else 1
        with torch.no_grad():
            for dim, axes in split:
                g = self.mesh.reduce_scatter(g, axes, dim - shift)
            if layer is None:
                self._grads[idx] = g
                return
            if idx not in self._grads:
                self._grads[idx] = torch.zeros(leaf.shape, dtype=torch.float32,
                                               device=leaf.device)
            self._grads[idx][layer] = g

    def grads(self) -> dict:
        """``{leaf index: this rank's fp32 gradient}`` of every split leaf:
        the pending sums (divided by the microbatches, as the whole-tree
        step divides each rank's sum before its reduce-scatter)
        reduce-scattered, in one order on every rank.  Call once, after the
        step's last microbatch."""
        self._regathered.clear()
        self.end_microbatch()
        for key in sorted(self._pending, key=lambda k: (k[0], -1 if k[1] is None else k[1])):
            g = self._pending.pop(key)
            self._reduce(key, g.div_(self.n_micro) if self.n_micro > 1 else g)
        for i, (leaf, _) in self._split.items():
            if i not in self._grads:  # a leaf the loss does not read
                self._grads[i] = torch.zeros(leaf.shape, dtype=torch.float32,
                                             device=leaf.device)
        return self._grads


@contextlib.contextmanager
def layer_gather(mesh, leaves: list, splits: list, *, n_micro: int = 1):
    """Run model code over FSDP shards: ``leaves`` (the params'
    ``tree_leaves``, this rank's shards) with ``splits`` (per leaf, the
    ``[(dim, axes)]`` of its data-axis splits; empty for a whole leaf).
    ``n_micro``: the train step's microbatches.  Yields the
    ``LayerGather``; with no split leaf nothing changes."""
    global _ACTIVE
    prev = _ACTIVE
    ctx = LayerGather(mesh, leaves, splits, n_micro)
    if not ctx.leaves:
        yield ctx
        return
    _ACTIVE = ctx
    try:
        with torch.autograd.graph.saved_tensors_hooks(ctx.pack, ctx.unpack):
            yield ctx
    finally:
        _ACTIVE = prev
        ctx._regathered.clear()
