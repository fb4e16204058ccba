"""The train step: microbatched gradient accumulation in fp32 ->
global-norm clip -> schedule -> AdamW (``repro.runtime.step``'s
``make_train_step``), on one device, or over a mesh's data axes with
explicit collectives (``ShardedTrainStep``, below).

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

from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    ef_int8_compress_decompress,
    make_schedule,
)
from repro_torch.runtime import sharding as S
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

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
                    inputs: torch.Tensor, labels: torch.Tensor):
    """``(loss, ce, moe_aux, grads)`` over the batch rows given, the
    gradients fp32 in ``tree_leaves`` order, accumulated over
    ``tcfg.microbatches`` (the reference's split) and averaged."""
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


def make_train_step(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    mesh=None,
    *,
    device: Optional[str | torch.device] = None,
) -> Callable[[dict, dict], tuple[dict, dict]]:
    """``(state, batch) -> (state, metrics)`` with metrics ``loss``, ``ce``,
    ``moe_aux``, ``grad_norm`` and ``lr`` (fp32 scalar tensors).  The device
    is ``cuda`` unless the caller passes one; attention runs the flash
    kernels on CUDA and their plain version on the CPU.  With a ``mesh``
    (``launch.mesh``) the step is a ``ShardedTrainStep``: the state holds
    this rank's shards and the batch this rank's rows."""
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

    return train_step


# ---------------------------------------------------------------------------
# The step over a mesh
# ---------------------------------------------------------------------------


def abstract_params(cfg: ModelConfig, dtype: torch.dtype = torch.float32) -> Tree:
    """The parameter tree of ``cfg`` as meta tensors (shapes and dtypes,
    no storage): ``T.init_params`` traced under a fake-tensor mode, so a
    full-size config allocates nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = T.init_params(cfg, torch.Generator().manual_seed(0), dtype=dtype)
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


LAYOUTS = ("tp", "dp256")


class ShardedTrainStep:
    """The reference's train step over a mesh's data axes, with explicit
    collectives (``mesh.all_reduce`` / ``all_gather`` / ``reduce_scatter``):

      * the batch rides ``dp_axes(mesh, layout)``: each rank gets the
        contiguous block of global rows ``batch_specs`` gives it
        (``shard_batch``), and peels microbatches off the minor position of
        its own rows, so microbatch j over all ranks is the reference's
      * FSDP (``tcfg.fsdp``): every leaf ``param_specs`` splits lives as
        this rank's shard; the whole tree is all-gathered before the
        forward, and its gradient reduce-scattered into the shard
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

    ``state_specs`` / ``batch_specs`` are the spec trees; ``init_state``,
    ``shard_state``, ``gather_state`` and ``shard_batch`` place trees under
    them.  ``last_collectives`` counts the previous call's collectives by
    kind.  ``layout="tp"`` with a ``model`` axis larger than 1 (tensor,
    expert and sequence parallelism) raises: that is the next slice."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh, *,
                 device: Optional[str | torch.device] = None):
        self.device = resolve_device(device)
        if mesh.device.type != self.device.type:
            raise ValueError(f"a {self.device.type} step on a {mesh.device.type} mesh")
        if tcfg.layout not in LAYOUTS:
            raise ValueError(f"layout {tcfg.layout!r}: one of {LAYOUTS}")
        if tcfg.layout == "tp" and S.axis_size(mesh, "model") > 1:
            raise NotImplementedError(
                f"layout 'tp' over a model axis of {mesh.shape['model']}: tensor, expert "
                "and sequence parallelism over 'model' come with the next scale-out slice "
                "(layout 'dp256' runs the model axis as data parallelism)"
            )
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.int8_ef = _check_compression(tcfg)
        self.schedule = make_schedule(tcfg)
        shapes = abstract_params(cfg, getattr(torch, tcfg.param_dtype))
        param_sp = S.param_specs(cfg, shapes, mesh=mesh, fsdp=tcfg.fsdp, layout=tcfg.layout)
        self.state_specs = {
            "params": param_sp,
            "opt": S.opt_state_specs(cfg, shapes, tcfg.zero1, mesh, fsdp=tcfg.fsdp,
                                     layout=tcfg.layout),
        }
        if self.int8_ef:
            self.state_specs["err"] = param_sp
        self.batch_specs = S.batch_specs(cfg, None, mesh, layout=tcfg.layout)
        self.dp = S.dp_axes(mesh, tcfg.layout)
        self.dp_size = mesh.size(self.dp)
        # per leaf, in tree_leaves order: the dims its params are split
        # over, the data axes its gradient is all-reduced over, whether this
        # rank counts it in the norm, and the spec of its ZeRO-1 block within
        # the params' (None when the moments split as the params do)
        self._split, self._reduce_axes, self._counted, self._zero1 = [], [], [], []
        for ps, ms in zip(tree_leaves(param_sp), tree_leaves(self.state_specs["opt"]["mu"])):
            split = S._sharded_dims(ps, mesh)
            split_axes = {a for _, axes in split for a in axes}
            if not split_axes <= set(self.dp):
                raise ValueError(f"spec {ps} splits a parameter over {split_axes - set(self.dp)}"
                                 f", not a data axis of layout {tcfg.layout!r}")
            rest = tuple(a for a in self.dp if a not in split_axes)
            self._split.append(split)
            self._reduce_axes.append(rest)
            self._counted.append(all(mesh.coordinate[a] == 0 for a in rest))
            extra = [(d, a) for d, a in S._sharded_dims(ms, mesh) if (d, a) not in split]
            block = [None] * len(ms)
            for d, a in extra:
                block[d] = a
            self._zero1.append(S.P(*block) if extra else None)
        self.last_collectives: dict = {}

    # -- placement ------------------------------------------------------
    def _place(self, fn, tree, specs):
        return tree_map(lambda t, s: fn(t, s, self.mesh), tree, specs)

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
    def __call__(self, state: dict, batch: dict) -> tuple[dict, dict]:
        mesh, dp = self.mesh, self.dp
        before = dict(mesh.collectives)
        params, opt = state["params"], state["opt"]
        local = tree_leaves(params)
        inputs = torch.as_tensor(batch["inputs"], device=self.device)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        full = [p if not split else
                S.gather_tensor(p.detach(), ps, mesh).requires_grad_(True)
                for p, split, ps in zip(local, self._split,
                                        tree_leaves(self.state_specs["params"]))]
        loss, ce, aux, grads = _loss_and_grads(self.cfg, self.tcfg,
                                               tree_unflatten(params, full), inputs, labels)
        del full
        with torch.no_grad():
            for i, g in enumerate(grads):
                for dim, axes in self._split[i]:
                    g = mesh.reduce_scatter(g, axes, dim)
                if self._reduce_axes[i]:
                    mesh.all_reduce(g, self._reduce_axes[i])
                grads[i] = g.div_(self.dp_size)
            if self.int8_ef:
                _require_err(state)
                errs = tree_leaves(state["err"])
                amax = torch.stack([torch.max(torch.abs(g.float() + e))
                                    for g, e in zip(grads, errs)])
                mesh.all_reduce(amax, dp, op="max")
                for i, err in enumerate(errs):
                    grads[i], new_err = ef_int8_compress_decompress(grads[i], err, amax=amax[i])
                    err.copy_(new_err)
            sq = torch.stack([torch.sum(torch.square(g.float())) if counted
                              else torch.zeros((), dtype=torch.float32, device=g.device)
                              for g, counted in zip(grads, self._counted)])
            mesh.all_reduce(sq, dp)
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
