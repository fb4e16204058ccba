"""A cost model of the eager step, counted as it runs (counterpart of
``repro.launch.hlo_cost``).

The reference compiles each cell with XLA and walks the optimized HLO.
Eager PyTorch compiles nothing, so the port runs the step once on ``meta``
tensors (shapes and dtypes, no storage, no device) and counts every op
the dispatcher sees.  In eager PyTorch every op that launches a kernel
reads its operands from HBM and writes its result there: the reference's
traffic model ("operands + result of every top-level op") with nothing
fused and no loop trip counts to roll up, since every layer runs.

  * ``CountingMode`` -- a ``TorchDispatchMode`` recording per op its
    launches, FLOPs, transcendentals and HBM bytes (the op rules below),
    and, through ``kernels/ops.py``'s counting hook, each hand-written
    kernel's cost as the card launches it (``kernels/cost.py``)
  * ``RecordingMesh`` -- one rank (coordinate 0 on every axis) of a named
    grid, on ``meta``: its collectives return tensors of the right shape
    and are priced by the reference's ring model on the result bytes
  * a peak-memory tracker over the live storages: the arguments, the
    outputs and the most bytes alive at once
  * ``analyze(fn, *args)`` -- the reference's ``analyze`` dict plus
    ``launches``, ``kernels``, ``memory`` and the per-op table

Every number is modelled from shapes, not measured.
"""
from __future__ import annotations

import collections
import math
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh

# ---------------------------------------------------------------------------
# op rules (the reference's categories, ``hlo_cost.py:49-64``)
# ---------------------------------------------------------------------------

#: ops that launch nothing and move no byte: allocation and metadata (every
#: view and alias op is also free: ``OpOverload.is_view``)
NO_LAUNCH = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "lift_fresh", "detach", "alias", "_unsafe_view", "set_", "resize_", "view",
    "_reshape_alias", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_has_compatible_shallow_copy_type", "_local_scalar_dense",
})
#: one FLOP per result element
ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum", "clamp",
    "clamp_min", "clamp_max", "eq", "ne", "lt", "le", "gt", "ge", "where", "masked_fill",
    "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "floor", "ceil", "round", "trunc", "sign", "remainder",
    "fmod", "pow", "reciprocal", "square", "relu", "threshold_backward", "addcmul",
    "addcdiv", "lerp", "sigmoid_backward", "tanh_backward", "isnan", "isinf",
})
#: one FLOP and one transcendental per result element
TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "rsqrt", "sqrt", "tanh",
    "sin", "cos", "tan", "atan2", "sigmoid", "erf", "erfc", "erfinv", "silu", "gelu",
    "softplus", "silu_backward", "gelu_backward", "softplus_backward",
})
#: one FLOP per element of the first input
REDUCE = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod", "any", "all",
    "logsumexp", "cumsum", "var", "std", "var_mean", "norm", "linalg_vector_norm",
    "_softmax_backward_data", "_log_softmax_backward_data",
})
#: a reduce plus one transcendental per input element
SOFTMAX = frozenset({"_softmax", "_log_softmax"})
#: reads O(result) rows of a table: 2 x result bytes plus the indices
GATHER = frozenset({"embedding", "index_select", "gather", "index", "take"})
#: in-place writes of a region: the values in, the region written, the indices
SCATTER = frozenset({"index_put_", "_index_put_impl_", "index_copy_", "index_add_",
                     "scatter_", "scatter_add_", "scatter_reduce_", "masked_scatter_",
                     "index_fill_"})

#: the ring model's wire bytes per result byte at group size g
RING = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _op_cost(func, args, kwargs, out) -> tuple[int, float, float, float]:
    """``(launches, flops, transcendentals, bytes)`` of one aten op."""
    name = func._overloadpacket.__name__
    if func.is_view or name in NO_LAUNCH:
        return 0, 0.0, 0.0, 0.0
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    base = name.rstrip("_") if name.endswith("_") and not name.startswith("_") else name
    out_elems = sum(t.numel() for t in outs)
    first_in = ins[0].numel() if ins else 0
    flops = trans = 0.0
    if func._overloadpacket in flop_registry:
        flops = float(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
    elif base in ELEMENTWISE:
        flops = float(out_elems)
    elif base in TRANSCENDENTAL:
        flops = trans = float(out_elems)
    elif base in REDUCE:
        flops = float(first_in)
    elif base in SOFTMAX:
        flops, trans = 4.0 * first_in, float(first_in)
    if name in GATHER:
        nbytes = 2 * sum(_nbytes(t) for t in outs) + sum(
            _nbytes(t) for t in ins if not t.is_floating_point())
    elif name in SCATTER:  # values of the target's type read and written, indices read
        nbytes = sum(_nbytes(t) * (2 if t.dtype == ins[0].dtype else 1) for t in ins[1:])
    elif name == "copy_":  # the destination is written, not read
        nbytes = _nbytes(ins[0]) + _nbytes(ins[1])
    elif name in ("fill_", "zero_"):
        nbytes = sum(_nbytes(t) for t in outs)
    else:
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
    launches = 0 if not ins and out_elems == 0 else 1
    return launches, flops, trans, float(nbytes)


# ---------------------------------------------------------------------------
# live storages
# ---------------------------------------------------------------------------


class LiveBytes:
    """The bytes of the storages alive among those it was shown, and the
    most alive at once: a storage is counted from the first time it is
    shown until it is freed (a finalizer on its Python object, which lives
    as long as the storage does)."""

    def __init__(self):
        self._sizes: dict = {}
        self.live = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> bool:
        """Count ``t``'s storage if it is new; returns whether it was."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return False
        self._sizes[key] = n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return True

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def keys(self, tensors) -> dict:
        """``{storage key: bytes}`` of ``tensors``' distinct storages."""
        return {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in tensors}


# ---------------------------------------------------------------------------
# the counting mode
# ---------------------------------------------------------------------------


class CountingMode(TorchDispatchMode):
    """Counts the ops run under it (on any device; the dry-run runs it on
    ``meta``).  ``impl``: "auto" prices each ``kernels/ops.py`` entry point
    as its hand-written kernels (``kernels/cost.py``), computing nothing;
    "torch" lets the plain versions run and counts their ops."""

    def __init__(self, impl: str = "auto"):
        super().__init__()
        if impl not in ("auto", "torch"):
            raise ValueError(f"impl {impl!r}: 'auto' (the kernels) or 'torch' (plain)")
        self.impl = impl
        self.flops = self.bytes = self.transcendentals = 0.0
        self.launches = 0
        #: aten op -> {"count", "launches", "flops", "bytes"}
        self.ops: dict = {}
        #: CUDA kernel symbol (or ``nccl:<kind>``) -> launches
        self.kernels: collections.Counter = collections.Counter()
        #: kernel counter (``ops.launch_counts()`` key) -> launches
        self.counters: collections.Counter = collections.Counter()
        #: collective kind -> {"count", "result_bytes", "wire_bytes", "group_sizes"}
        self.collectives: dict = {}
        self.memory = LiveBytes()

    def __enter__(self):
        ops.COUNTING.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.COUNTING.remove(self)
        return super().__exit__(*exc)

    def _add(self, name: str, launches: int, flops: float, trans: float, nbytes: float):
        rec = self.ops.setdefault(name, {"count": 0, "launches": 0, "flops": 0.0,
                                         "bytes": 0.0})
        rec["count"] += 1
        rec["launches"] += launches
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self.launches += launches
        self.flops += flops
        self.transcendentals += trans
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._add(str(func._overloadpacket), *_op_cost(func, args, kwargs, out))
        for t in _tensors(out):
            self.memory.add(t)
        return out

    def launch(self, cost, outputs):
        """Record one kernel entry point's call (``kernels.cost.KernelCost``)
        and return its ``outputs`` (allocated by the caller)."""
        self._add(f"kernel:{cost.counter}", cost.launches, cost.flops, cost.transcendentals,
                  cost.bytes)
        for symbol, n in cost.kernels:
            self.kernels[symbol] += n
        self.counters[cost.counter] += cost.launches
        return outputs

    def collective(self, kind: str, result_bytes: float, group: int) -> None:
        """Record one collective of ``result_bytes`` over ``group`` ranks,
        priced by the ring model (one launch)."""
        wire = result_bytes * RING[kind](group) if group > 1 else 0.0
        rec = self.collectives.setdefault(kind, {"count": 0, "result_bytes": 0.0,
                                                 "wire_bytes": 0.0, "group_sizes": set()})
        rec["count"] += 1
        rec["result_bytes"] += result_bytes
        rec["wire_bytes"] += wire
        rec["group_sizes"].add(group)
        self.kernels[f"nccl:{kind}"] += 1
        self.launches += 1


def _active() -> Optional[CountingMode]:
    return next((c for c in reversed(ops.COUNTING) if isinstance(c, CountingMode)), None)


# ---------------------------------------------------------------------------
# the recording mesh
# ---------------------------------------------------------------------------


class RecordingMesh(Mesh):
    """One rank, coordinate 0 on every axis, of a ``shape`` grid over
    ``axis_names``, on ``device`` (``meta`` by default) and over no process
    group: ``launch.mesh.Mesh``'s placement (``axes``, ``size``, ``index``),
    and collectives that run the real mesh's local reshapes, return tensors
    of the right shape without moving data, and are recorded
    (``collectives`` by kind as ``Mesh``'s, priced by the active
    ``CountingMode``)."""

    def __init__(self, shape: tuple, axis_names: tuple, device="meta"):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match the axes {axis_names}")
        self.device = torch.device(device)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = 0
        self.coordinate = {a: 0 for a in self.axis_names}
        self.collectives: collections.Counter = collections.Counter()

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape.values())

    def _record(self, kind: str, result: torch.Tensor, axes: tuple) -> None:
        self.collectives[kind.replace("-", "_")] += 1
        mode = _active()
        if mode is not None:
            mode.collective(kind, float(_nbytes(result)), self.size(axes))

    def all_reduce(self, t: torch.Tensor, axes: tuple, op: str = "sum") -> torch.Tensor:
        self._record("all-reduce", t, axes)
        return t

    def all_gather(self, t: torch.Tensor, axes: tuple, dim: int) -> torch.Tensor:
        x = t.movedim(dim, 0).contiguous()
        out = torch.empty((self.size(axes) * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        self._record("all-gather", out, axes)
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, axes: tuple, dim: int) -> torch.Tensor:
        n = self.size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {n} ways")
        x = t.movedim(dim, 0).contiguous()
        out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype, device=x.device)
        self._record("reduce-scatter", out, axes)
        return out.movedim(0, dim)


# ---------------------------------------------------------------------------
# analyze
# ---------------------------------------------------------------------------


def analyze(fn, *args, impl: str = "auto", table: bool = False) -> dict:
    """Run ``fn(*args)`` once under a ``CountingMode`` and return the
    reference's ``analyze`` dict (per-device ``flops``, ``bytes_accessed``,
    ``transcendentals``, ``collective_result_bytes`` /
    ``collective_wire_bytes`` and ``collectives`` by kind) plus
    ``launches``, ``kernels`` (launches by CUDA kernel symbol),
    ``kernel_counters`` (by ``ops.launch_counts()`` key), ``memory`` (the
    argument and output bytes, the most bytes alive at once and the rest
    as the reference names them) and, with ``table``, ``ops`` (the per-op
    table).  ``fn``'s collectives go through a ``RecordingMesh``."""
    mode = CountingMode(impl)
    arg_tensors = _tensors(args)
    for t in arg_tensors:
        mode.memory.add(t)
    arg_keys = mode.memory.keys(arg_tensors)
    with mode:
        out = fn(*args)
    out_keys = mode.memory.keys(_tensors(out))
    arg_bytes = sum(arg_keys.values())
    alias = sum(n for k, n in out_keys.items() if k in arg_keys)
    out_bytes = sum(out_keys.values())
    peak = mode.memory.peak
    result = {
        "flops": mode.flops,
        "bytes_accessed": mode.bytes,
        "transcendentals": mode.transcendentals,
        "collective_result_bytes": sum(v["result_bytes"] for v in mode.collectives.values()),
        "collective_wire_bytes": sum(v["wire_bytes"] for v in mode.collectives.values()),
        "collectives": {k: dict(v, group_sizes=sorted(v["group_sizes"]))
                        for k, v in mode.collectives.items()},
        "launches": mode.launches,
        "kernels": dict(mode.kernels),
        "kernel_counters": dict(mode.counters),
        "memory": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": peak - arg_bytes,
            "peak_bytes_per_device": peak,
        },
    }
    if table:
        result["ops"] = mode.ops
    return result
