"""The train step: microbatched gradient accumulation in fp32 ->
global-norm clip -> schedule -> AdamW (``repro.runtime.step``'s
``make_train_step`` and its ``TrainStepArtifacts``, whose ``jitted()``
replays the step as one CUDA graph on the card), on one device, or over a
mesh with explicit collectives (``ShardedTrainStep``, below); and the
serve steps on a mesh
(``make_serve_step`` / ``make_prefill_step``, last), with the reference's
abstract trees (``abstract_params``, ``abstract_train_state``,
``abstract_batch``, ``abstract_cache``: meta tensors).

The state is ``{"params", "opt"}`` as in the reference, plus ``"err"``
(fp32 error-feedback buffers shaped like the params) under
``grad_compression="int8_ef"``: there each fp32 gradient leaf is quantized
to int8 and dequantized with error feedback
(``optim.ef_int8_compress_decompress``) before the clip, as the
reference's step does at world size 1.  The step updates
the parameters and the optimizer state IN PLACE (the reference's jit
donates them) and returns the same state dict: a full-size model keeps one
copy of its weights, moments and gradients on the card.  Batches may be
numpy arrays (``SyntheticDataset``) or tensors; they are moved to the
step's device.  ``inputs`` are int tokens [B, S], or for an
``embed_inputs`` config (audio, VLM) fp32 embeddings [B, S, d_model], which
go through the copy and the microbatch split unchanged (the reference's
``abstract_batch``).  Every launch goes to the current stream and nothing
waits for the device: the metrics are device scalars.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models import act_sharding as AS
from repro_torch.models import fsdp as FS
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.act_sharding import activation_sharding
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    ef_int8_compress_decompress,
    make_schedule,
)
from repro_torch.runtime import sharding as S
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path, tree_unflatten

Tree = Any

GRAD_COMPRESSIONS = ("none", "int8_ef")


def init_train_state(params: Tree, tcfg: Optional[TrainConfig] = None) -> dict:
    """``{"params", "opt"}`` over a trainable copy of ``params`` with fresh
    AdamW state, and ``"err"`` (fp32 zeros shaped like the params) when
    ``tcfg.grad_compression == "int8_ef"``.  The step updates the copy in
    place, so the caller's tensors (and an engine built on them) keep the
    initial weights, as the reference's immutable arrays do."""
    own = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    state = {"params": own, "opt": adamw_init(own)}
    if tcfg is not None and tcfg.grad_compression == "int8_ef":
        state["err"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), own)
    return state


def _microbatch(x: torch.Tensor, n_micro: int, j: int) -> torch.Tensor:
    """Microbatch ``j`` of ``n_micro``: rows j, j + n, j + 2n, ... -- the
    reference's split (the microbatch index is the batch dim's minor
    position)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    return x.reshape(b // n_micro, n_micro, *x.shape[1:])[:, j]


def _loss_and_grads(cfg: ModelConfig, tcfg: TrainConfig, params: Tree,
                    inputs: torch.Tensor, labels: torch.Tensor,
                    after_micro: Callable[[], None] = lambda: None):
    """``(loss, ce, moe_aux, grads)`` over the batch rows given, the
    gradients fp32 in ``tree_leaves`` order, accumulated over
    ``tcfg.microbatches`` (the reference's split) and averaged;
    ``after_micro`` runs after each microbatch's backward."""
    compute_dtype = getattr(torch, tcfg.compute_dtype)
    n_micro = max(1, tcfg.microbatches)

    def one(inputs, labels):
        loss, metrics = T.lm_loss(
            cfg, params, inputs, labels,
            remat_policy=tcfg.remat_policy, compute_dtype=compute_dtype,
        )
        leaves = tree_leaves(params)
        # an ``embed_inputs`` config never reads its embedding table here:
        # its gradient is zero, as JAX's is for an unused leaf
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        after_micro()
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), metrics, grads

    if n_micro == 1:
        loss, metrics, grads = one(inputs, labels)
        grads = [g.float() for g in grads]
        return loss, metrics["ce"].detach(), metrics["moe_aux"].detach(), grads
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_leaves(params)]
    losses, ces, auxes = [], [], []
    for j in range(n_micro):
        l, m, g = one(_microbatch(inputs, n_micro, j), _microbatch(labels, n_micro, j))
        for acc, gj in zip(grads, g):
            acc.add_(gj.float())
        losses.append(l)
        ces.append(m["ce"].detach())
        auxes.append(m["moe_aux"].detach())
    for acc in grads:
        acc.div_(n_micro)
    return (torch.stack(losses).mean(), torch.stack(ces).mean(),
            torch.stack(auxes).mean(), grads)


def _check_compression(tcfg: TrainConfig) -> bool:
    """Whether the step runs int8 error feedback; raises on a mode the port
    lacks."""
    if tcfg.grad_compression not in GRAD_COMPRESSIONS:
        raise NotImplementedError(
            f"grad_compression={tcfg.grad_compression!r}: the port has "
            f"{GRAD_COMPRESSIONS}"
        )
    return tcfg.grad_compression == "int8_ef"


def _require_err(state: dict) -> None:
    if "err" not in state:
        raise ValueError("grad_compression='int8_ef' needs state['err']: build "
                         "the state with init_train_state(params, tcfg)")


#: the step's metrics, each a replicated fp32 scalar (the reference's
#: ``metric_specs``)
METRICS = ("loss", "ce", "moe_aux", "grad_norm", "lr")


class _OneDevice:
    """The one-device mesh the reference's rules see without a mesh (its
    ``launch.mesh.make_dev_mesh()``): the rules read ``shape`` and
    ``axis_names`` alone."""

    axis_names = ("data", "model")
    shape = {"data": 1, "model": 1}


def _train_specs(cfg: ModelConfig, tcfg: TrainConfig, mesh) -> tuple:
    """``(abstract params, state specs, batch specs, metric specs)``: the
    reference's spec trees of a train step on ``mesh``."""
    shapes = abstract_params(cfg, getattr(torch, tcfg.param_dtype))
    param_sp = S.param_specs(cfg, shapes, mesh=mesh, fsdp=tcfg.fsdp, layout=tcfg.layout)
    state = {"params": param_sp,
             "opt": S.opt_state_specs(cfg, shapes, tcfg.zero1, mesh, fsdp=tcfg.fsdp,
                                      layout=tcfg.layout)}
    if tcfg.grad_compression == "int8_ef":
        state["err"] = param_sp
    return (shapes, state, S.batch_specs(cfg, None, mesh, layout=tcfg.layout),
            {k: S.P() for k in METRICS})


@dataclasses.dataclass(eq=False)
class TrainStepArtifacts:
    """The reference's ``TrainStepArtifacts``: ``step(state, batch) ->
    (state, metrics)`` with the spec trees of the state, the batch and the
    metrics (without a mesh, those of the reference's rules on its
    one-device mesh), the abstract trees, the initial state and the
    placements (the reference's ``state_shardings`` / ``batch_shardings``:
    ``shard_state``, ``gather_state``, ``shard_batch``; without a mesh
    every tree is whole).  Calling the artifacts runs ``step`` eagerly;
    ``jitted()`` is the reference's compiled step."""

    step: Callable[[dict, dict], tuple[dict, dict]]
    cfg: ModelConfig
    tcfg: TrainConfig
    mesh: Any
    state_specs: Tree
    batch_specs: Tree
    metric_specs: Tree
    device: Optional[torch.device] = None

    def __call__(self, state: dict, batch: dict) -> tuple[dict, dict]:
        return self.step(state, batch)

    def jitted(self, donate: bool = True) -> Callable[[dict, dict], tuple[dict, dict]]:
        """The reference's compiled step, with ``step``'s signature.  On a
        CUDA device (one device, or a CUDA mesh over NCCL) each call
        replays the whole step as one CUDA graph (``_GraphedTrainStep``);
        on the CPU, and on a mesh over gloo, the artifacts themselves (the
        eager step).  ``donate=False`` raises ``NotImplementedError``: the
        port's step updates the state in place, which is what the
        reference's donated call does; a step that left its input state
        intact would copy every leaf each call, and the reference's
        callers' ``donate=False`` only keeps their state readable, which
        the in-place state is."""
        if not donate:
            raise NotImplementedError(
                "donate=False: the port's train step updates the state in place (the "
                "reference's donated call); it keeps no copy of the input state")
        if self.device.type != "cuda":
            return self
        return _GraphedTrainStep(self)

    # -- abstract inputs ----------------------------------------------------
    def abstract_state(self) -> dict:
        return abstract_train_state(self.cfg, self.tcfg)

    def abstract_batch(self, shape: ShapeConfig) -> dict:
        return abstract_batch(self.cfg, shape)

    # -- real initialization and placement ------------------------------------
    def init_state(self, params: Tree) -> dict:
        """``init_train_state(params, tcfg)`` (the reference's
        ``init_state(key)``: the caller draws ``params`` from its seeded
        ``torch.Generator`` through ``T.init_params``)."""
        return init_train_state(params, self.tcfg)

    def shard_state(self, full: dict) -> dict:
        """A copy of a full state (params trainable)."""
        local = tree_map(lambda t: t.detach().clone(), full)
        tree_map(lambda p: p.requires_grad_(True), local["params"])
        return local

    def gather_state(self, local: dict) -> dict:
        """The full state (detached)."""
        return tree_map(lambda t: t.detach(), local)

    def shard_batch(self, batch: dict) -> dict:
        """The batch as tensors on the step's device."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}


class _GraphedTrainStep:
    """``TrainStepArtifacts.jitted()`` on a CUDA device: ``(state, batch)
    -> (state, metrics)``, the whole step (the microbatched forward and
    backward, the collectives, int8 EF, the clip, the schedule and AdamW)
    replayed as one CUDA graph (``serving.graphs.AddressedGraphs``,
    ``graphs``).  The state's leaves are read and written where they live,
    the batch is copied into static buffers (host data is moved to the
    device first), the metrics are cloned out, and the state returned is
    the caller's.  A state's first call is its warm-up: the eager step on
    the capture stream, whose result the call returns; the capture after
    it launches nothing.  A state at new addresses (a remesh, a restart
    that rebinds) captures anew, and a graph is dropped once its state's
    tensors die.  What the step records in Python
    (``ShardedTrainStep.last_collectives``, ``max_live_gathered_bytes``,
    the mesh's collective counts) is recorded by the warm-up and the
    capture, not by a replay, which does what the capture recorded.  Any
    other attribute is the artifacts'."""

    def __init__(self, art: TrainStepArtifacts):
        from repro_torch.serving.graphs import AddressedGraphs

        self.art = art
        self.graphs = AddressedGraphs(lambda state, batch: art.step(state, batch)[1],
                                      warm_by_call=True)

    def __call__(self, state: dict, batch: dict) -> tuple[dict, dict]:
        batch = {k: torch.as_tensor(v, device=self.art.device) for k, v in batch.items()}
        return state, self.graphs(state, batch)

    def __getattr__(self, name: str):
        if name == "art":  # not set yet (a copy under construction)
            raise AttributeError(name)
        return getattr(self.art, name)


def make_train_step(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    mesh=None,
    *,
    device: Optional[str | torch.device] = None,
) -> TrainStepArtifacts:
    """The train step's ``TrainStepArtifacts``: ``step(state, batch) ->
    (state, metrics)`` with metrics ``loss``, ``ce``, ``moe_aux``,
    ``grad_norm`` and ``lr`` (fp32 scalar tensors).  The device is
    ``cuda`` unless the caller passes one; attention runs the flash kernels
    on CUDA and their plain version on the CPU.  With a ``mesh``
    (``launch.mesh``) the artifacts are a ``ShardedTrainStep``: the state
    holds this rank's shards and the batch this rank's rows."""
    device = resolve_device(device)
    if mesh is not None:
        return ShardedTrainStep(cfg, tcfg, mesh, device=device)
    int8_ef = _check_compression(tcfg)
    schedule = make_schedule(tcfg)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params, opt = state["params"], state["opt"]
        inputs = torch.as_tensor(batch["inputs"], device=device)
        labels = torch.as_tensor(batch["labels"], device=device)
        loss, ce, aux, grads = _loss_and_grads(cfg, tcfg, params, inputs, labels)
        if int8_ef:
            _require_err(state)
            with torch.no_grad():
                for i, err in enumerate(tree_leaves(state["err"])):
                    # the dequantized gradient replaces the gradient; the
                    # residual is the next step's error feedback
                    grads[i], new_err = ef_int8_compress_decompress(grads[i], err)
                    err.copy_(new_err)
        grads, gnorm = clip_by_global_norm(tree_unflatten(params, grads), tcfg.grad_clip_norm)
        lr = schedule(opt["step"])
        adamw_update(grads, opt, params, lr=lr, cfg=tcfg)
        return state, {"loss": loss, "ce": ce, "moe_aux": aux, "grad_norm": gnorm, "lr": lr}

    _, state_sp, batch_sp, metric_sp = _train_specs(cfg, tcfg, _OneDevice())
    return TrainStepArtifacts(step=train_step, cfg=cfg, tcfg=tcfg, mesh=None,
                              state_specs=state_sp, batch_specs=batch_sp,
                              metric_specs=metric_sp, device=device)


# ---------------------------------------------------------------------------
# The step over a mesh
# ---------------------------------------------------------------------------


def abstract_params(cfg: ModelConfig, dtype: torch.dtype = torch.float32) -> Tree:
    """The parameter tree of ``cfg`` as meta tensors (shapes and dtypes,
    no storage): ``T.init_params`` of one layer (the hybrid: one cycle)
    traced under a fake-tensor mode, its ``[L, ...]`` stacks then given
    the config's depth, so a full-size config allocates nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    per = cfg.shared_attn_every if cfg.family == "hybrid" else 1
    with FakeTensorMode():
        fake = T.init_params(dataclasses.replace(cfg, num_layers=per),
                             torch.Generator().manual_seed(0), dtype=dtype)
    depth = cfg.num_layers // per
    return tree_map_with_path(
        lambda path, t: torch.empty((depth, *t.shape[1:]) if path.startswith("layers/")
                                    else t.shape, dtype=t.dtype, device="meta"), fake)


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig) -> dict:
    """``init_train_state``'s tree as meta tensors: the params in
    ``tcfg.param_dtype``, fp32 moments, an int32 step, and fp32 ``err``
    under ``int8_ef``."""
    params = abstract_params(cfg, getattr(torch, tcfg.param_dtype))
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    state = {"params": params, "opt": {
        "mu": tree_map(f32, params), "nu": tree_map(f32, params),
        "step": torch.empty((), dtype=torch.int32, device="meta")}}
    if tcfg.grad_compression == "int8_ef":
        state["err"] = tree_map(f32, params)
    return state


def abstract_batch(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """A global batch of ``shape`` as meta tensors: int32 labels [B, S] and
    int32 tokens, or fp32 embeddings [B, S, d] for an ``embed_inputs``
    config."""
    b, s = shape.global_batch, shape.seq_len
    batch = {"labels": torch.empty((b, s), dtype=torch.int32, device="meta")}
    batch["inputs"] = (torch.empty((b, s, cfg.d_model), dtype=torch.float32, device="meta")
                       if cfg.embed_inputs else
                       torch.empty((b, s), dtype=torch.int32, device="meta"))
    return batch


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """``T.init_cache``'s dense cache as meta tensors."""
    return T.init_cache(cfg, batch, max_seq, dtype, device="meta")


LAYOUTS = ("tp", "dp256")


class ShardedTrainStep(TrainStepArtifacts):
    """The reference's train step over a mesh, with explicit collectives
    (``mesh.all_reduce`` / ``all_gather`` / ``reduce_scatter``):

      * the batch rides ``dp_axes(mesh, layout)``: each rank gets the
        contiguous block of global rows ``batch_specs`` gives it
        (``shard_batch``), and peels microbatches off the minor position of
        its own rows, so microbatch j over all ranks is the reference's
      * FSDP (``tcfg.fsdp``): every leaf ``param_specs`` splits lives as
        this rank's shard; the forward gathers one layer at a time (and the
        backward again) and reduce-scatters each layer's gradient into the
        shard (``models.fsdp``), so the gathered weights alive at once are
        one layer's plus the leaves outside the stacks in use
      * every other gradient is all-reduced; the sum over the data axes is
        divided by their size (the mean of the ranks' row means)
      * ``int8_ef``: the EF quantizer runs on the reduced gradient, each
        leaf's scale from its largest ``|g + err|`` over its shards (one
        all-reduce); ``err`` lives sharded like the params
      * the clip's global norm sums each leaf's squares on its shard, a
        leaf replicated over an axis counted on that axis' first rank only,
        in one all-reduce
      * ZeRO-1 (``tcfg.zero1``): AdamW's moments live as the shards
        ``opt_state_specs`` gives; the update runs on the matching block of
        the gradient and the parameter, whose blocks are then all-gathered
      * ``layout="tp"`` over a ``model`` axis larger than 1: leaves split
        over ``model`` stay this rank's blocks through the forward (only
        their FSDP splits are gathered), the model code runs Megatron TP,
        expert and vocab parallelism and the SSM mixers on a ``d_inner``
        block under ``act_sharding`` (the model ranks of one data index see
        the same rows; a Mamba2 split that is not whole SSM heads raises
        ``ValueError``), a replicated leaf that a rank uses only
        in part (``sharding.model_partial``) has its gradient summed over
        ``model`` too, and the norm counts a leaf replicated over ``model``
        on model rank 0 only.  So every rank's gradient of every leaf is its
        block of the single-device gradient.

    A ``TrainStepArtifacts`` whose ``step`` is the call itself:
    ``state_specs`` / ``batch_specs`` / ``metric_specs`` are the spec trees;
    ``init_state``, ``shard_state``, ``gather_state`` and ``shard_batch``
    place trees under them.  ``grads`` gives one step's reduced gradients
    without the update.
    ``last_collectives`` counts the previous call's collectives by kind,
    ``max_live_gathered_bytes`` the most FSDP-gathered bytes alive at once
    in any call."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh, *,
                 device: Optional[str | torch.device] = None):
        self.device = resolve_device(device)
        if mesh.device.type != self.device.type:
            raise ValueError(f"a {self.device.type} step on a {mesh.device.type} mesh")
        if tcfg.layout not in LAYOUTS:
            raise ValueError(f"layout {tcfg.layout!r}: one of {LAYOUTS}")
        plan = S.ShardingPlan(cfg, mesh, tcfg.layout)
        SSM.check_head_split(cfg, plan.model)
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.int8_ef = _check_compression(tcfg)
        self.schedule = make_schedule(tcfg)
        self.act_specs = S.activation_specs(cfg, mesh, batch_sharded=True, layout=tcfg.layout)
        shapes, self.state_specs, self.batch_specs, self.metric_specs = _train_specs(
            cfg, tcfg, mesh)
        param_sp = self.state_specs["params"]
        self.dp = S.dp_axes(mesh, tcfg.layout)
        self.dp_size = mesh.size(self.dp)
        model = ("model",) if plan.model > 1 else ()
        # the axes the norm's squares, the EF scales and the loss means
        # reduce over
        self.all_axes = self.dp + model
        # per leaf, in tree_leaves order: the dims its params are split over
        # the data axes (gathered for the forward), the axes its gradient is
        # all-reduced over, whether this rank counts it in the norm, and the
        # spec of its ZeRO-1 block within the params' (None when the moments
        # split as the params do)
        self._split, self._reduce_axes, self._counted, self._zero1 = [], [], [], []
        partial = tree_leaves(tree_map_with_path(lambda path, _: S.model_partial(path, plan),
                                                 shapes))
        for ps, ms, part in zip(tree_leaves(param_sp), tree_leaves(self.state_specs["opt"]["mu"]),
                                partial):
            split = S._sharded_dims(ps, mesh)
            local = [(d, axes) for d, axes in split if model and axes == model]
            split = [x for x in split if x not in local]
            split_axes = {a for _, axes in split for a in axes}
            if not split_axes <= set(self.dp):
                raise ValueError(f"spec {ps} splits a parameter over {split_axes - set(self.dp)}"
                                 f", not a data axis of layout {tcfg.layout!r}")
            rest = tuple(a for a in self.dp if a not in split_axes)
            self._split.append(split)
            self._reduce_axes.append(rest + (model if part else ()))
            self._counted.append(all(mesh.coordinate[a] == 0 for a in rest
                                     + (model if not local else ())))
            extra = [(d, a) for d, a in S._sharded_dims(ms, mesh)
                     if (d, a) not in split and (d, a) not in local]
            block = [None] * len(ms)
            for d, a in extra:
                block[d] = a
            self._zero1.append(S.P(*block) if extra else None)
        self.last_collectives: dict = {}
        self.max_live_gathered_bytes = 0

    @property
    def step(self) -> Callable[[dict, dict], tuple[dict, dict]]:
        return self.__call__

    # -- placement ------------------------------------------------------
    def _place(self, fn, tree, specs):
        """``fn(leaf, spec, mesh)`` over ``tree``, in the spec tree's key
        order: the step pairs leaves with its per-leaf lists by position,
        and a tree built elsewhere (``bridge.params_from_numpy``: the
        reference's sorted keys) may hold the same keys in another order."""
        return tree_map(lambda s, t: fn(t, s, self.mesh), specs, tree)

    def shard_state(self, full: dict) -> dict:
        """This rank's shards of a full state (copies, params trainable)."""
        local = self._place(lambda t, s, m: S.shard_tensor(t.detach(), s, m).clone(), full,
                            {k: self.state_specs[k] for k in full})
        tree_map(lambda p: p.requires_grad_(True), local["params"])
        return local

    def gather_state(self, local: dict) -> dict:
        """The full state from every rank's shards (all-gathers; detached)."""
        return self._place(lambda t, s, m: S.gather_tensor(t.detach(), s, m), local,
                           {k: self.state_specs[k] for k in local})

    def init_state(self, params: Tree) -> dict:
        """``init_train_state``'s state, sharded: this rank's copy of the
        full ``params``' shards, zero moments at their ZeRO-1 shapes (never
        allocated in full), ``err`` under ``int8_ef``."""
        own = self._place(lambda t, s, m: S.shard_tensor(t.detach(), s, m).clone()
                          .requires_grad_(True), params, self.state_specs["params"])
        zeros = lambda t, s, m: torch.zeros(S.shard_tensor(t, s, m).shape, dtype=torch.float32,
                                            device=t.device)
        mom = self.state_specs["opt"]["mu"]
        state = {"params": own, "opt": {
            "mu": self._place(zeros, params, mom), "nu": self._place(zeros, params, mom),
            "step": torch.zeros((), dtype=torch.int32, device=self.device)}}
        if self.int8_ef:
            state["err"] = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                          device=p.device), own)
        return state

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch (tensors on the step's device)."""
        return {k: S.shard_tensor(torch.as_tensor(v, device=self.device), self.batch_specs[k],
                               self.mesh) for k, v in batch.items()}

    # -- the step -------------------------------------------------------
    def grads(self, state: dict, batch: dict) -> tuple:
        """``(loss, ce, moe_aux, grads)`` of this rank's rows: the
        gradients (fp32, ``tree_leaves`` order, this rank's blocks) reduced
        over the mesh and divided by the data ranks, before error feedback,
        the clip and the update; the metrics this rank's."""
        mesh = self.mesh
        params = state["params"]
        inputs = torch.as_tensor(batch["inputs"], device=self.device)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        # only the data-axis (FSDP) splits are gathered, a layer at a time:
        # model blocks stay
        with activation_sharding(mesh, self.act_specs), FS.layer_gather(
                mesh, tree_leaves(params), self._split,
                n_micro=max(1, self.tcfg.microbatches)) as gather:
            loss, ce, aux, grads = _loss_and_grads(self.cfg, self.tcfg, params, inputs, labels,
                                                   gather.end_microbatch)
            split_grads = gather.grads()  # reduce-scattered
        self.max_live_gathered_bytes = max(self.max_live_gathered_bytes,
                                           gather.max_live_gathered_bytes)
        with torch.no_grad():
            for i, g in enumerate(grads):
                g = split_grads.get(i, g)
                if self._reduce_axes[i]:
                    mesh.all_reduce(g, self._reduce_axes[i])
                grads[i] = g.div_(self.dp_size)
        return loss, ce, aux, grads

    def __call__(self, state: dict, batch: dict) -> tuple[dict, dict]:
        mesh, dp = self.mesh, self.dp
        before = dict(mesh.collectives)
        params, opt = state["params"], state["opt"]
        local = tree_leaves(params)
        loss, ce, aux, grads = self.grads(state, batch)
        with torch.no_grad():
            if self.int8_ef:
                _require_err(state)
                errs = tree_leaves(state["err"])
                amax = torch.stack([torch.max(torch.abs(g.float() + e))
                                    for g, e in zip(grads, errs)])
                mesh.all_reduce(amax, self.all_axes, op="max")
                for i, err in enumerate(errs):
                    grads[i], new_err = ef_int8_compress_decompress(grads[i], err, amax=amax[i])
                    err.copy_(new_err)
            sq = torch.stack([torch.sum(torch.square(g.float())) if counted
                              else torch.zeros((), dtype=torch.float32, device=g.device)
                              for g, counted in zip(grads, self._counted)])
            mesh.all_reduce(sq, self.all_axes)
            grads, gnorm = clip_by_global_norm(tree_unflatten(params, grads),
                                               self.tcfg.grad_clip_norm,
                                               norm=torch.sqrt(torch.sum(sq)))
            lr = self.schedule(opt["step"])
            # ZeRO-1: the update on this rank's block of each leaf (views)
            blocks = [(g, p) if z is None else
                      (S.shard_tensor(g, z, mesh), S.shard_tensor(p, z, mesh))
                      for g, p, z in zip(tree_leaves(grads), local, self._zero1)]
            adamw_update(tree_unflatten(params, [g for g, _ in blocks]), opt,
                         tree_unflatten(params, [p for _, p in blocks]), lr=lr, cfg=self.tcfg)
            for (_, block), p, z in zip(blocks, local, self._zero1):
                if z is not None:
                    p.copy_(S.gather_tensor(block, z, mesh))
            means = torch.stack([loss, ce, aux])
            mesh.all_reduce(means, dp)
            loss, ce, aux = means.div_(self.dp_size).unbind()
        self.last_collectives = {k: v - before.get(k, 0) for k, v in mesh.collectives.items()}
        return state, {"loss": loss, "ce": ce, "moe_aux": aux, "grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Serve steps (decode / prefill) on a mesh
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _serve_gather(art: "ServeStepArtifacts", params: Tree):
    """The serve step's FSDP context over this rank's ``params``: each
    leaf's data-axis splits gathered a layer at a time as the model code
    runs (``models.fsdp``); its ``model`` blocks stay this rank's.  Records
    the most gathered bytes alive at once on ``art``."""
    mesh = art.mesh
    data_splits = lambda t, spec: (t, [(d, a) for d, a in S._sharded_dims(spec, mesh)
                                       if "model" not in a])
    pairs = tree_leaves(tree_map(data_splits, params, art.param_specs))
    with FS.layer_gather(mesh, [t for t, _ in pairs], [s for _, s in pairs]) as gather:
        yield
    art.max_live_gathered_bytes = max(art.max_live_gathered_bytes,
                                      gather.max_live_gathered_bytes)


@dataclasses.dataclass
class ServeStepArtifacts:
    """A serve step on a mesh and its spec trees (the reference's, from the
    mesh's ``shape`` and ``axis_names`` alone, so a stand-in mesh builds
    them).  ``step`` runs on this rank's tensors: ``(params, tokens,
    cache) -> (next_tokens, cache)`` for decode, ``(params, inputs) ->
    (logits, cache)`` for prefill, the logits this rank's vocab columns.
    ``shard_*`` give this rank's blocks of full trees, ``gather_*`` the full
    trees back (all-gathers); a batch that does not cover the data axes
    (``batch_sharded`` False) is replicated over them, whatever the
    reference's prefill specs name.  ``jitted()`` is the reference's
    compiled step: on a CUDA mesh ``step`` replayed as a CUDA graph."""

    step: Callable
    cfg: ModelConfig
    mesh: Any
    shape: ShapeConfig
    param_specs: Tree
    input_specs: Tree  # tokens / prompt inputs
    cache_specs: Optional[Tree]
    out_specs: Tree
    compute_dtype: Any
    abstract_inputs: Callable = None
    batch_sharded: bool = True
    #: the most FSDP-gathered bytes alive at once in any call of ``step``
    max_live_gathered_bytes: int = 0

    def jitted(self, donate_cache: bool = True) -> Callable:
        """The reference's compiled step, with ``step``'s signature.  On a
        CUDA mesh each call replays ``step`` as a CUDA graph
        (``serving.graphs.AddressedGraphs``, counted in the callable's
        ``graphs.captures``): the weights are read where they live (a call
        whose weights sit elsewhere captures anew; a graph is dropped when
        the weights it read die), the tokens, the cache index and the
        prompt rows copied in.  A decode's cache leaves are the graph's own
        buffers, one set per cache shapes: the first call's cache becomes
        them, a cache that sits elsewhere (a new prefill's) is copied in,
        and the call returns them, written in place (the reference's
        donated cache: pass back what was returned).  The other outputs
        are the graph's, cloned (a prefill's logits and new cache, a
        decode's tokens and index).  What the
        step records in Python (``max_live_gathered_bytes``, the mesh's
        collective counts) is recorded at the capture, not at a replay.  On
        the CPU ``step`` itself.  A stand-in mesh whose ranks meet in Python
        (threads taking turns) cannot be captured: call ``step`` there.

        A capture over several NCCL ranks has not run: the card's machine
        holds one.  ``donate_cache=False`` raises ``NotImplementedError``:
        the port's decode step writes the caller's cache in place, which is
        what the reference's donated call does; a step that left its input
        cache intact would copy every leaf each call, and no caller of the
        reference asks for it."""
        if not donate_cache and self.cache_specs is not None:
            raise NotImplementedError(
                "donate_cache=False: the port's decode step writes the cache in place "
                "(the reference's donated call); it keeps no copy of the input cache")
        if self.mesh.device.type != "cuda":
            return self.step
        from repro_torch.serving.graphs import AddressedGraphs

        if self.cache_specs is None:
            graphs = AddressedGraphs(lambda params, inp: self.step(params, inp["inputs"]))

            def call(params, inputs):
                return graphs(params, {"inputs": inputs})
        else:
            cfg = self.cfg
            # a recurrent state the capture's warm-up steps is put back
            states = lambda held: tree_leaves(T.chunk_recurrent_states(cfg, held[1]["layers"])
                                              or {})
            graphs = AddressedGraphs(lambda held, inp: self.step(
                held[0], inp["tokens"], dict(held[1], index=inp["index"])), kept=states,
                cache=True)

            def call(params, tokens, cache):
                rest = {k: v for k, v in cache.items() if k != "index"}
                return graphs((params, rest), {"tokens": tokens, "index": cache["index"]})
        call.graphs = graphs
        return call

    def _place(self, fn, tree, specs):
        return tree_map(lambda t, sp: fn(t, sp, self.mesh), tree, specs)

    def _rows(self, spec: S.P) -> S.P:
        return spec if self.batch_sharded else S.P(None, *spec[1:])

    def shard_params(self, full: Tree) -> Tree:
        return self._place(lambda t, sp, m: S.shard_tensor(t, sp, m).contiguous(), full,
                           self.param_specs)

    def shard_inputs(self, full: torch.Tensor) -> torch.Tensor:
        return S.shard_tensor(full, self._rows(self.input_specs), self.mesh).contiguous()

    def shard_cache(self, full: dict) -> dict:
        """This rank's blocks of a full cache (an 8-bit leaf moved as its
        codes, bit for bit)."""
        specs = self.out_specs[1]
        block = lambda t, sp, m: S.shard_tensor(L.cache_bytes(t), sp, m).contiguous().view(
            t.dtype)
        return {"index": full["index"],
                "layers": self._place(block, full["layers"], specs["layers"])}

    def gather_cache(self, local: dict) -> dict:
        """The full cache from every rank's blocks (all-gathers; an 8-bit
        leaf gathered as its codes: gloo has no float8)."""
        specs = self.out_specs[1]
        whole = lambda t, sp, m: S.gather_tensor(L.cache_bytes(t), sp, m).view(t.dtype)
        return {"index": local["index"],
                "layers": self._place(whole, local["layers"], specs["layers"])}

    def gather_output(self, local: torch.Tensor) -> torch.Tensor:
        """The full first output (decode tokens, prefill logits)."""
        return S.gather_tensor(local, self._rows(self.out_specs[0]), self.mesh)


def _serve_fsdp(cfg: ModelConfig, mesh, override: Optional[bool]) -> bool:
    """FSDP serve weights when the model-sharded copy alone would crowd
    device memory (> ~8 GiB a rank in bf16)."""
    if override is not None:
        return override
    model = S.axis_size(mesh, "model")
    return cfg.param_count() * 2 / model > 8 * 1024**3


def _serve_common(cfg, mesh, shape, compute_dtype, fsdp, cache_dtype):
    """The two serve steps' shared part: ``(batch_sharded, activation
    specs, param specs, cache specs, the dense cache's sequence entry,
    abstract params, abstract cache)``.  The cache is in ``cache_dtype``:
    ``None`` or the compute dtype, or an 8-bit float (``layers.FP8_DTYPES``,
    the reference's quantized cache: a plain cast, no scale); any other pair
    raises ``NotImplementedError``."""
    cache_dtype = cache_dtype or compute_dtype
    SSM.check_head_split(cfg, S.ShardingPlan(cfg, mesh).model)
    if cache_dtype != compute_dtype and cache_dtype not in L.FP8_DTYPES:
        raise NotImplementedError(
            f"cache_dtype {cache_dtype} under compute dtype {compute_dtype}: the port's "
            f"serve steps keep the cache in the compute dtype or in {L.FP8_DTYPES}")
    dp_size = 1
    for a in S.dp_axes(mesh):
        dp_size *= mesh.shape[a]
    batch_sharded = shape.global_batch % dp_size == 0 and shape.global_batch >= dp_size
    act_specs = S.activation_specs(cfg, mesh, batch_sharded=batch_sharded)
    params_abs = abstract_params(cfg, compute_dtype)
    cache_abs = abstract_cache(cfg, shape.global_batch, shape.seq_len, cache_dtype)
    p_specs = S.param_specs(cfg, params_abs, mesh=mesh, fsdp=_serve_fsdp(cfg, mesh, fsdp))
    c_specs = S.cache_specs(cfg, cache_abs, shape, mesh)
    kv = c_specs["layers"].get("k", c_specs["layers"].get("shared_k"))
    seq = kv[2] if kv is not None else None
    return batch_sharded, act_specs, p_specs, c_specs, seq, params_abs, cache_abs


def make_serve_step(
    cfg: ModelConfig,
    mesh,
    shape: ShapeConfig,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    fsdp: Optional[bool] = None,
    cache_dtype: Optional[torch.dtype] = None,
) -> ServeStepArtifacts:
    """One-token decode microstep on ``mesh``: ``(params, tokens [B],
    cache) -> (next_tokens [B], cache)`` over this rank's blocks (tokens
    ride the data axes when the batch covers them).  The cache is the dense
    one of ``cache_specs``: its K/V heads on ``model``, or its sequence on
    ``model`` (and on the data axes when the batch does not cover them),
    its ``index`` ([] or [B]) replicated.  The argmax is reduced over the
    split vocab (ties to the lowest index).  ``cache_dtype``: the cache's
    (``_serve_common``).  FSDP weights (``fsdp``, or the model too large for
    a rank) are gathered a layer at a time (``models.fsdp``)."""
    batch_sharded, act_specs, p_specs, c_specs, seq, params_abs, cache_abs = _serve_common(
        cfg, mesh, shape, compute_dtype, fsdp, cache_dtype)
    dp = S.dp_axes(mesh)
    tok_spec = S.P(dp) if batch_sharded else S.P()

    @torch.no_grad()
    def decode(params, tokens, cache):
        index = cache["index"]
        local = index
        if index.ndim == 1 and batch_sharded:
            local = S.shard_tensor(index, S.P(dp), mesh)
        with activation_sharding(mesh, act_specs, cache_seq=seq), _serve_gather(art, params):
            logits, new = T.decode_step(cfg, params, tokens, dict(cache, index=local),
                                        compute_dtype=compute_dtype)
            out = (AS.vocab_argmax(logits) if AS.split("btv")
                   else torch.argmax(logits, dim=-1).to(torch.int32))
        return out, dict(new, index=index + 1)

    def abstract_inputs():
        tokens = torch.empty((shape.global_batch,), dtype=torch.int32, device="meta")
        return params_abs, tokens, cache_abs

    art = ServeStepArtifacts(
        step=decode, cfg=cfg, mesh=mesh, shape=shape, param_specs=p_specs,
        input_specs=tok_spec, cache_specs=c_specs, out_specs=(tok_spec, c_specs),
        compute_dtype=compute_dtype, abstract_inputs=abstract_inputs,
        batch_sharded=batch_sharded)
    return art


#: the dense cache's K/V leaves (the hybrid's Mamba2 ``conv_x`` is 5-dim too)
KV_LEAVES = ("k", "v", "shared_k", "shared_v")


def make_prefill_step(
    cfg: ModelConfig,
    mesh,
    shape: ShapeConfig,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    impl: str = "auto",
    fsdp: Optional[bool] = None,
    cache_dtype: Optional[torch.dtype] = None,
) -> ServeStepArtifacts:
    """Full-sequence prefill on ``mesh``: ``(params, inputs [B, S]) ->
    (last logits [B, V], cache at seq_len)`` over this rank's blocks, the
    logits this rank's vocab columns and the cache this rank's block of
    ``cache_specs`` (each rank computes its rows' whole prompt, its KV
    heads, and keeps its block of the sequence), in ``cache_dtype``
    (``T.prefill`` casts K / V and the recurrent conv states as it writes
    them; an 8-bit recurrent state then does not decode, as in the
    reference)."""
    batch_sharded, act_specs, p_specs, c_specs, seq, params_abs, cache_abs = _serve_common(
        cfg, mesh, shape, compute_dtype, fsdp, cache_dtype)
    dp = S.dp_axes(mesh)
    in_spec = S.P(dp, None, None) if cfg.embed_inputs else S.P(dp, None)
    seq_spec = S.P(*[None] * 2, seq)  # the K/V leaves' sequence dim

    @torch.no_grad()
    def prefill_step(params, inputs):
        with activation_sharding(mesh, act_specs), _serve_gather(art, params):
            logits, cache = T.prefill(cfg, params, inputs, shape.seq_len, impl=impl,
                                      compute_dtype=compute_dtype, cache_dtype=cache_dtype)
        layers = tree_map_with_path(
            lambda path, t: S.shard_tensor(L.cache_bytes(t), seq_spec, mesh).contiguous()
            .view(t.dtype) if path.split("/")[-1] in KV_LEAVES else t, cache["layers"])
        return logits, dict(cache, layers=layers)

    def abstract_inputs():
        b, s = shape.global_batch, shape.seq_len
        inp = (torch.empty((b, s, cfg.d_model), dtype=torch.float32, device="meta")
               if cfg.embed_inputs else torch.empty((b, s), dtype=torch.int32, device="meta"))
        return params_abs, inp

    plan = S.ShardingPlan(cfg, mesh)
    art = ServeStepArtifacts(
        step=prefill_step, cfg=cfg, mesh=mesh, shape=shape, param_specs=p_specs,
        input_specs=in_spec, cache_specs=None, out_specs=(S.P(dp, plan.vocab()), c_specs),
        compute_dtype=compute_dtype, abstract_inputs=abstract_inputs,
        batch_sharded=batch_sharded)
    return art
