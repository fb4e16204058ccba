"""Partition-spec rules: DP / TP / EP / SP / FSDP over the production mesh
(own copy of ``repro.runtime.sharding``, as host logic over the port's
nested-dict trees).

Axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod.  Batch rides ``(pod, data)``; weights ride ``model``:

  * TP (Megatron pairing): attention heads + FFN hidden on ``model`` --
    column-parallel in (wq/wk/wv, wg/wu), row-parallel out (wo, wd).
  * EP: MoE expert dim on ``model``; router replicated.
  * Vocab: embedding + LM head sharded on ``model``.
  * SP (decode): when the KV-head count does not divide ``model``, the KV
    cache shards its *sequence* dim on ``model`` instead.
  * SSM: Mamba1 / Mamba2 ``d_inner`` on ``model`` (the mixer's
    column-parallel in, row-parallel out; the paired ``in_proj`` halves
    placed by ``Halves``).
  * FSDP: parameters / moments additionally shard a large *free* dim over
    ``data`` (ZeRO-3).

**Divisibility rule**: a dim is sharded only when ``dim % axis_size == 0``;
otherwise it stays replicated.  Specs are assigned by parameter-path
pattern, so a new weight fails loudly: any leaf must match a rule.

A spec (``P``) is a tuple with one entry per leading dim: ``None``, an
axis name, or a tuple of names (a dim split over their product, row major
in the mesh's order, as GSPMD splits it).  The rules read a mesh's
``shape`` (name -> size) and ``axis_names`` only, so they run over any
stand-in and over shape trees (meta tensors, the reference's
``ShapeDtypeStruct``s).  ``shard_tensor`` and ``gather_tensor`` take the
place of the reference's ``named``: this rank's block of a full tensor,
and the all-gather back (along a ``Halves`` spec's paired dim, the r-th
block of each half).  The port's train and serve steps
(``runtime.step``) execute every rule: the data axes by their
collectives, the ``model`` axis through the model code's
(``models.act_sharding``), whose gradient rule ``model_partial`` gives.
"""
from __future__ import annotations

import re
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.tree import tree_map_with_path

Tree = Any

FSDP_MIN_ELEMENTS = 1 << 20  # don't bother FSDP-sharding tiny leaves


class P(tuple):
    """A partition spec: ``P("data", None)``; trailing dims not listed are
    replicated.  Entries are canonical as the reference's
    ``PartitionSpec`` keeps them: a one-name tuple is the name, an empty
    tuple ``None``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            (None if not p else p[0] if len(p) == 1 else p) if isinstance(p, tuple) else p
            for p in parts))

    def __repr__(self) -> str:
        return f"{type(self).__name__}{tuple.__repr__(self)}"


class Halves(P):
    """The spec of a leaf whose last dim holds two halves side by side
    (Mamba1's ``in_proj`` ``[x | z]``, Mamba2's ``in_proj_zx`` ``[z | x]``):
    equal, as a tuple, to the reference's spec, but a split of that dim
    places the r-th block of EACH half on rank r (``[x_r | z_r]``), so a
    rank's halves line up with its contiguous ``d_inner`` blocks of the
    conv, ``dt_proj``, ``out_proj`` and the cache (``shard_tensor``,
    ``gather_tensor``).  The rules keep the class through FSDP and ZeRO-1,
    which never split the paired dim (it is not free)."""


def dp_axes(mesh, layout: str = "tp") -> tuple:
    """Axes carrying the batch.  ``dp256`` folds the model axis into data
    parallelism (pure DP + ZeRO-3)."""
    if layout == "dp256":
        return tuple(a for a in mesh.axis_names if a in ("pod", "data", "model"))
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


class ShardingPlan:
    """Divisibility-resolved axis choices for one (cfg, mesh, layout)."""

    def __init__(self, cfg: ModelConfig, mesh, layout: str = "tp"):
        self.cfg = cfg
        self.layout = layout
        self.model = axis_size(mesh, "model") if layout == "tp" else 1
        self.data = axis_size(mesh, "data")
        m = self.model
        h_phys = cfg.num_heads_physical
        self.heads_shardable = m > 1 and h_phys > 0 and h_phys % m == 0
        self.kv_shardable = m > 1 and cfg.num_kv_heads > 0 and cfg.num_kv_heads % m == 0
        self.ff_shardable = m > 1 and cfg.d_ff > 0 and cfg.d_ff % m == 0
        self.vocab_shardable = m > 1 and cfg.vocab_size % m == 0
        self.di_shardable = m > 1 and cfg.d_inner % m == 0 if cfg.ssm_state else False
        self.experts_shardable = m > 1 and cfg.num_experts > 0 and cfg.num_experts % m == 0

    def h(self):  # attention q/o head axis
        return "model" if self.heads_shardable else None

    def kv(self):  # attention k/v head axis
        return "model" if self.kv_shardable else None

    def ff(self):
        return "model" if self.ff_shardable else None

    def vocab(self):
        return "model" if self.vocab_shardable else None

    def di(self):
        return "model" if self.di_shardable else None

    def e(self):
        return "model" if self.experts_shardable else None


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


def _stack_dims(path: str, cfg: ModelConfig) -> int:
    """Leading stacked-layer dims of a leaf (scan stacks are unsharded)."""
    if path.startswith("layers/"):
        return 2 if cfg.family == "hybrid" else 1
    return 0


def _param_rule(path: str, ndim: int, cfg: ModelConfig, plan: ShardingPlan) -> P:
    """Spec for one parameter leaf; the rule applies to the trailing weight
    dims."""
    stack = _stack_dims(path, cfg)
    lead = (None,) * stack
    trailing = ndim - stack

    def spec(*tail):
        if len(tail) != trailing:
            raise ValueError(f"rule for {path!r} takes {len(tail)} weight dims, the leaf "
                             f"has {trailing}")
        return P(*lead, *tail)

    if re.search(r"(^|/)embed$", path):
        return P(plan.vocab(), None)
    if re.search(r"(^|/)lm_head$", path):
        return P(None, plan.vocab())
    if re.search(r"final_norm$", path):
        return P(None)
    # --- attention ---
    if re.search(r"attn/wq$", path):
        return spec(None, plan.h(), None)  # [d, H, hd]
    if re.search(r"attn/w[kv]$", path):
        return spec(None, plan.kv(), None)  # [d, kvH, hd]
    if re.search(r"attn/wo$", path):
        return spec(plan.h(), None, None)  # [H, hd, d]
    if re.search(r"attn/bq$", path):
        return spec(plan.h(), None)
    if re.search(r"attn/b[kv]$", path):
        return spec(plan.kv(), None)
    if re.search(r"attn/(q|k)_norm$", path):
        return spec(None)
    # --- dense MLP ---
    if re.search(r"ffn/w[gu]$", path) and cfg.family != "moe":
        return spec(None, plan.ff())
    if re.search(r"ffn/wd$", path) and cfg.family != "moe":
        return spec(plan.ff(), None)
    # --- MoE (expert parallel) ---
    if re.search(r"ffn/router$", path):
        return spec(None, None)
    if re.search(r"ffn/w[gud]$", path):
        return spec(plan.e(), None, None)  # [E, d, f] / [E, f, d]
    # --- norms ---
    if re.search(r"ln\d?$", path) or re.search(r"/ln$", path):
        return spec(None)
    # --- mamba1 ---
    if re.search(r"mixer/in_proj(_zx)?$", path):
        return (Halves if plan.di() else P)(*spec(None, plan.di()))
    if re.search(r"mixer/(conv_w|conv_x_w|conv_bc_w)$", path):
        return spec(None, plan.di()) if "bc" not in path else spec(None, None)
    if re.search(r"mixer/(conv_b|conv_x_b)$", path):
        return spec(plan.di())
    if re.search(r"mixer/conv_bc_b$", path):
        return spec(None)
    if re.search(r"mixer/x_proj$", path):
        return spec(plan.di(), None)
    if re.search(r"mixer/dt_proj$", path):
        return spec(None, plan.di())
    if re.search(r"mixer/dt_bias$", path):
        return spec(plan.di()) if cfg.ssm_version == 1 else spec(None)
    if re.search(r"mixer/A_log$", path):
        return spec(plan.di(), None) if cfg.ssm_version == 1 else spec(None)
    if re.search(r"mixer/D$", path):
        return spec(plan.di()) if cfg.ssm_version == 1 else spec(None)
    if re.search(r"mixer/out_proj$", path):
        return spec(plan.di(), None)
    # --- mamba2 ---
    if re.search(r"mixer/in_proj_bcdt$", path):
        return spec(None, None)
    if re.search(r"mixer/gate_norm$", path):
        return spec(plan.di())
    raise ValueError(f"no sharding rule for parameter {path!r} (ndim={ndim})")


def model_partial(path: str, plan: ShardingPlan) -> bool:
    """Whether a leaf replicated over ``model`` gets only a part of its
    gradient on each model rank, so that the ranks' gradients must be
    summed over ``model``: the K / V projections (and their biases) when
    the q heads split and the KV heads do not (each rank reads the KV heads
    of its q heads), the q / k norms when the heads split, the MoE router
    when the experts split (its gradient flows through the local experts'
    gates), and Mamba2's replicated leaves when ``d_inner`` splits
    (``in_proj_bcdt`` and ``conv_bc``, whose B / C / dt every rank's heads
    read, and ``A_log`` / ``D`` / ``dt_bias``, each rank reading its heads'
    entries).  Every other replicated leaf gets its whole gradient on every
    rank (its input is all-reduced back by ``copy_to_model``)."""
    if plan.model == 1:
        return False
    if re.search(r"mixer/(in_proj_bcdt|conv_bc_[wb]|A_log|D|dt_bias)$", path):
        return plan.cfg.ssm_version == 2 and plan.di() is not None
    if re.search(r"attn/(w[kv]|b[kv])$", path):
        return plan.h() is not None and plan.kv() is None
    if re.search(r"attn/(q|k)_norm$", path):
        return plan.h() is not None
    if re.search(r"ffn/router$", path):
        return plan.e() is not None
    return False


def _add_fsdp(
    spec: P, shape: tuple, stack: int, data_size: int,
    axes: tuple = ("data",), axis_sizes: Optional[dict] = None,
) -> P:
    """Shard the largest still-free trailing dim over the fsdp ``axes``
    (ZeRO-3).  With ``axes=("data", "model")`` (dp256 layout) it tries the
    joint product first, then each axis separately on distinct dims."""
    if data_size <= 1:
        return spec
    n_el = 1
    for d in shape:
        n_el *= d
    if n_el < FSDP_MIN_ELEMENTS:
        return spec
    sizes = axis_sizes or {"data": data_size}
    parts = list(spec) + [None] * (len(shape) - len(spec))

    def place(ax_group) -> bool:
        size = 1
        for a in ax_group:
            size *= sizes.get(a, 1)
        best, best_dim = -1, -1
        for i in range(stack, len(shape)):
            if parts[i] is None and shape[i] % size == 0 and shape[i] > best:
                best, best_dim = shape[i], i
        if best_dim >= 0:
            parts[best_dim] = ax_group if len(ax_group) > 1 else ax_group[0]
            return True
        return False

    if len(axes) > 1 and place(tuple(axes)):
        return type(spec)(*parts)
    for a in axes:
        place((a,))
    if any(p is not None for p in parts[stack:]) or spec != P(*parts):
        return type(spec)(*parts)
    return spec


def param_specs(
    cfg: ModelConfig, params_shape: Tree, *, mesh, fsdp: bool = False,
    layout: str = "tp",
) -> Tree:
    """Spec tree mirroring ``params_shape`` (any leaves with ``.shape``)."""
    plan = ShardingPlan(cfg, mesh, layout)
    data_size = axis_size(mesh, "data")
    fsdp_axes = ("data", "model") if layout == "dp256" else ("data",)
    axis_sizes = {a: axis_size(mesh, a) for a in ("data", "model")}

    def assign(path, leaf):
        spec = _param_rule(path, len(leaf.shape), cfg, plan)
        if fsdp:
            spec = _add_fsdp(spec, tuple(leaf.shape), _stack_dims(path, cfg), data_size,
                             axes=fsdp_axes, axis_sizes=axis_sizes)
        return spec

    return tree_map_with_path(assign, params_shape)


def opt_state_specs(
    cfg: ModelConfig, params_shape: Tree, zero1: bool, mesh, *,
    fsdp: bool = False, layout: str = "tp",
) -> Tree:
    """AdamW moment specs.  With ``zero1`` the moments additionally shard
    over ``data`` on the first dim that divides evenly (ZeRO-1: sharded
    optimizer update, then the fresh params are all-gathered)."""
    base = param_specs(cfg, params_shape, mesh=mesh, fsdp=fsdp, layout=layout)
    if not zero1:
        mom = base
    else:
        data_size = axis_size(mesh, "data")

        def add_data(path, leaf, spec):
            parts = list(spec)
            parts += [None] * (len(leaf.shape) - len(parts))
            used = set()
            for pt in parts:
                if pt is not None:
                    used |= set(pt if isinstance(pt, tuple) else (pt,))
            if "data" in used:  # fsdp already covers it
                return spec
            for i, (dim, ax) in enumerate(zip(leaf.shape, parts)):
                if ax is None and dim % data_size == 0 and dim >= data_size:
                    parts[i] = "data"
                    return type(spec)(*parts)
            return spec

        mom = tree_map_with_path(add_data, params_shape, base)
    return {"mu": mom, "nu": mom, "step": P()}


def state_specs(
    cfg: ModelConfig, state_shape: Tree, *, zero1: bool, mesh, fsdp: bool = False
) -> Tree:
    return {
        "params": param_specs(cfg, state_shape["params"], mesh=mesh, fsdp=fsdp),
        "opt": opt_state_specs(cfg, state_shape["params"], zero1, mesh, fsdp=fsdp),
    }


# ---------------------------------------------------------------------------
# Data / cache specs
# ---------------------------------------------------------------------------


def batch_specs(
    cfg: ModelConfig, shape: Optional[ShapeConfig], mesh, layout: str = "tp"
) -> Tree:
    dp = dp_axes(mesh, layout)
    spec = {"labels": P(dp, None)}
    if cfg.embed_inputs:
        spec["inputs"] = P(dp, None, None)
    else:
        spec["inputs"] = P(dp, None)
    return spec


def cache_specs(cfg: ModelConfig, cache_shape: Tree, shape: ShapeConfig, mesh) -> Tree:
    """Decode-cache specs.

    Batch rides (pod, data) when it covers the axis; otherwise (long-context
    batch=1) the sequence dim rides it.  KV heads ride ``model`` when they
    divide it; otherwise the cache *sequence* dim rides ``model`` instead
    (flash-decode sequence parallelism)."""
    plan = ShardingPlan(cfg, mesh)
    dp = dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    batch_shardable = shape.global_batch % dp_size == 0 and shape.global_batch >= dp_size
    b_ax = dp if batch_shardable else None
    if plan.kv_shardable:
        kvh_ax, s_model = "model", None
    else:
        kvh_ax, s_model = None, "model"
    s_ax: Any = s_model
    if not batch_shardable:
        s_ax = (dp + (s_model,)) if s_model else dp
        if isinstance(s_ax, tuple) and len(s_ax) == 1:
            s_ax = s_ax[0]

    def assign(p, leaf):
        nd = len(leaf.shape)
        if p == "index":
            return P() if nd == 0 else P(b_ax)
        # attention kv caches: [L, B, S, kvH, hd] (or [C, B, S, kvH, hd] hybrid)
        if re.search(r"(^|/)(k|v|shared_k|shared_v)$", p):
            return P(None, b_ax, s_ax, kvh_ax, None)
        # mamba states (leading stack dims: 1 for ssm, 2 for hybrid)
        stack = 2 if cfg.family == "hybrid" else 1
        lead = (None,) * stack
        if p.endswith("conv") or p.endswith("conv_x"):
            return P(*lead, b_ax, None, plan.di())
        if p.endswith("conv_bc"):
            return P(*lead, b_ax, None, None)
        if p.endswith("/h") or p == "h":
            if cfg.family == "hybrid":  # [C, k, B, nh, hp, ds]
                return P(*lead, b_ax, plan.di(), None, None)
            return P(*lead, b_ax, plan.di(), None)  # [L, B, di, ds]
        raise ValueError(f"no cache sharding rule for {p!r}")

    return {"index": P(), "layers": tree_map_with_path(assign, cache_shape["layers"])}


def logits_spec(cfg: ModelConfig, mesh) -> P:
    plan = ShardingPlan(cfg, mesh)
    return P(dp_axes(mesh), None, plan.vocab())


def activation_specs(
    cfg: ModelConfig, mesh, *, batch_sharded: bool = True, layout: str = "tp"
) -> dict:
    """Kind -> spec table for the activation anchors (``b`` = batch, ``t``
    = sequence position): btd residual, bthd q / attention out, btkv k / v,
    btf MLP hidden, btv logits, bti / bi mamba inner stream, ecd MoE expert
    buffer, bv decode logits, bhtd / bht flash-attention carries."""
    plan = ShardingPlan(cfg, mesh, layout)
    b = dp_axes(mesh, layout) if batch_sharded else None
    return {
        "btd": P(b, None, None),
        "bthd": P(b, None, plan.h(), None),
        "btkv": P(b, None, plan.kv(), None),
        "btf": P(b, None, plan.ff()),
        "btv": P(b, None, plan.vocab()),
        "bti": P(b, None, plan.di()),
        "bi": P(b, plan.di()),
        "ecd": P(plan.e(), None, None),
        "bv": P(b, plan.vocab()),
        "bhtd": P(b, plan.h(), None, None),
        "bht": P(b, plan.h(), None),
    }


# ---------------------------------------------------------------------------
# Placement (the reference's ``named`` + ``device_put``)
# ---------------------------------------------------------------------------


def _sharded_dims(spec: P, mesh) -> list:
    """``[(dim, axes)]`` for every dim ``spec`` splits over the mesh."""
    out = []
    for dim, entry in enumerate(spec):
        axes = mesh.axes(entry)
        if axes:
            out.append((dim, axes))
    return out


def _paired(spec: P, dim: int) -> bool:
    """Whether ``dim`` of a leaf under ``spec`` is a ``Halves`` pair."""
    return isinstance(spec, Halves) and dim == len(spec) - 1


def shard_tensor(full: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view of it): along
    each split dim, the block at the rank's row-major coordinate on the
    dim's axes; along a ``Halves`` pair, that block of each half side by
    side (a copy)."""
    out = full
    for dim, axes in _sharded_dims(spec, mesh):
        n = mesh.size(axes)
        parts = 2 * n if _paired(spec, dim) else n
        if full.shape[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split {n} ways "
                             f"over {axes}" + (" in each half" if parts > n else ""))
        size = full.shape[dim] // parts
        if parts > n:
            out = out.unflatten(dim, (2, n, size)).select(dim + 1, mesh.index(axes))
            out = out.flatten(dim, dim + 1)
        else:
            out = out.narrow(dim, mesh.index(axes) * size, size)
    return out


def gather_tensor(local: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full tensor from every rank's block under ``spec``: one
    all-gather over each split dim's axes (``local`` itself when ``spec``
    splits nothing); a ``Halves`` pair's blocks ``[a_0 b_0 a_1 b_1 ..]``
    put back in order, ``[a_0 a_1 .. b_0 b_1 ..]``."""
    out = local
    for dim, axes in _sharded_dims(spec, mesh):
        out = mesh.all_gather(out, axes, dim)
        if _paired(spec, dim):
            n = mesh.size(axes)
            out = out.unflatten(dim, (n, 2, out.shape[dim] // (2 * n)))
            out = out.transpose(dim, dim + 1).flatten(dim, dim + 2)
    return out
