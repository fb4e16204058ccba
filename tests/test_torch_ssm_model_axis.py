"""The Mamba1 (falcon-mamba) and Zamba2 hybrid families over the model
axis, on the CPU over gloo: ``d_inner`` split over ``model`` as the
reference's specs place it (``runtime.sharding``), with the paired
``in_proj`` / ``in_proj_zx`` halves placed ``[x_r | z_r]``.

  * the train step (``ShardedTrainStep``, ``layout="tp"``) at ``(data,
    model)`` = (1, 2), (1, 4) and (2, 2) against the port's single-device
    step over three steps: every rank's gradient of every leaf at every
    step, and its parameter, moment and error-feedback blocks after them,
    equal to its blocks of the single-device run within ``RTOL`` of the
    leaf's max (under FSDP, ZeRO-1, microbatches, remat ``"full"`` once per
    family; int8 error feedback compared after one step, an element on a
    quantization boundary allowed one quantum apart); each case's first
    step against ``jax.value_and_grad`` of the reference's ``lm_loss``
    (loss, grad norm, each rank's gradient blocks; the mean over the batch's
    two halves, ``_reference_grads``), the ranks starting from the bridge's
    weights (``tests/test_torch_tp_step.py``'s rules)
  * a checkpoint -> restore and a ``remesh`` between (1, 4) and (2, 2), one
    direction per family
  * the serve steps: ``make_prefill_step`` + ``DECODE_STEPS`` greedy
    ``make_serve_step`` steps on each rank's blocks against the
    reference's unsharded ``T.prefill`` + ``T.decode_step`` (fp32): tokens
    equal, logits and every leaf of the gathered cache within ``RTOL`` of
    their max; a hybrid with 2 KV heads at model 4, whose shared K/V cache
    splits its sequence (``make_prefill_step`` picks the K/V leaves by
    name: the hybrid's ``conv_x`` state is 5-dim too)
  * placement: shard -> gather of every leaf (params and moments) bit-equal
    for both families on every layout, with FSDP and ZeRO-1 on and off; the
    paired leaves' local blocks are the r-th block of each half
  * a Mamba2 split that does not fall on whole SSM heads raises

One spawn of 2 ranks and one of 4 (each rank one torch thread, a
``FileStore`` in ``tmp_path``, FSDP's size floor lowered to 1024 so the
smoke leaves shard).  The test process writes the reference's weights
for the ranks, then computes the reference's runs and the single-device
step while they run; the ranks do not load JAX.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import TrainConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticDataset
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.act_sharding import activation_sharding
from repro_torch.runtime import Trainer, init_train_state, make_train_step
from repro_torch.runtime import sharding as S
from repro_torch.runtime import step as step_mod
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

RTOL = 1e-5
#: against the reference (``tests/test_torch_train.py``'s): the loss
#: absolute, each gradient relative to its leaf's max |g|
REF_LOSS_ATOL, REF_GRAD_RTOL = 1e-5, 1e-4
FLIP_SHARE = 1e-3
#: parameters after AdamW steps, of the leaf's max (``_close``)
ADAM_RTOL = 1e-4
STEPS = 3
SEQ, BATCH = 16, 4
#: the serve steps: a PROMPT-token prompt in a SERVE_SEQ-row cache
SERVE_SEQ, PROMPT, DECODE_STEPS = 32, 12, 8
SPAWN_TIMEOUT_S = 150
FSDP_MIN = 1024
DM = ("data", "model")
ARCHS = {"falcon": "falcon-mamba-7b", "zamba2": "zamba2-2.7b"}
#: (case name, config name, TrainConfig overrides, mesh shape)
STEP_CASES = {
    2: [
        ("ssm_tp2_remat_full", "falcon", dict(remat_policy="full"), (1, 2)),
        ("hybrid_tp2_micro2", "zamba2", dict(microbatches=2), (1, 2)),
    ],
    4: [
        ("ssm_tp4_zero1", "falcon", dict(zero1=True), (1, 4)),
        ("hybrid_tp4_remat_full", "zamba2", dict(remat_policy="full"), (1, 4)),
        ("ssm_2x2_fsdp_zero1_micro2", "falcon", dict(fsdp=True, zero1=True, microbatches=2),
         (2, 2)),
        ("hybrid_2x2_fsdp_zero1_int8", "zamba2",
         dict(fsdp=True, zero1=True, grad_compression="int8_ef"), (2, 2)),
    ],
}
#: Trainer round trips on 4 ranks: (name, config, mesh before, mesh after)
REMESH_CASES = [("ssm_tp4_to_2x2", "falcon", (1, 4), (2, 2)),
                ("hybrid_2x2_to_tp4", "zamba2", (2, 2), (1, 4))]
#: serve steps: (case name, config name, mesh shape, batch)
SERVE_CASES = {
    2: [("ssm_serve_1x2", "falcon", (1, 2), 4), ("hybrid_serve_1x2", "zamba2", (1, 2), 4)],
    4: [("ssm_serve_1x4", "falcon", (1, 4), 4),
        ("hybrid_seq_serve_1x4", "zamba2_kv2", (1, 4), 4),
        ("hybrid_serve_2x2", "zamba2", (2, 2), 4)],
}
#: placement round trips: (layout, fsdp, zero1)
PLACEMENTS = [("tp", False, False), ("tp", True, True), ("tp", False, True),
              ("dp256", True, True)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(name, package=configs):
    """A case's config, of the port (or, ``package``, of the reference)."""
    if name in ARCHS:
        return package.smoke_config(ARCHS[name])
    # 4 q heads over 2 KV heads: at model 4 the q heads split and the KV
    # heads do not, so the shared block's cache splits its sequence
    return dataclasses.replace(package.smoke_config(ARCHS["zamba2"]),
                               name="zamba2-kv2-smoke", num_kv_heads=2)


def _tcfg(**kw) -> TrainConfig:
    base = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, compute_dtype="float32",
                zero1=False, fsdp=False)
    base.update(kw)
    return TrainConfig(**base)


def _batches(cfg, n=STEPS):
    ds = SyntheticDataset(cfg=cfg, seq_len=SEQ, global_batch=BATCH, seed=0)
    return [ds.next_batch() for _ in range(n)]


def _steps(overrides) -> int:
    """Steps a case compares: one under int8 error feedback (a flipped
    quantum moves a weight by up to the learning rate), else ``STEPS``."""
    return 1 if overrides.get("grad_compression") == "int8_ef" else STEPS


@functools.lru_cache(maxsize=None)
def _np_params(name):
    """The reference's weights of a case's config (numpy), once per module."""
    import jax

    from repro import configs as jconfigs
    from repro.models import transformer as JT

    return jax.tree.map(np.array, JT.init_params(_cfg(name, jconfigs), jax.random.PRNGKey(0)))


def _params(name, tmp):
    """The reference's weights as the port's tree, as the test process wrote
    them for the ranks (the bridge's key order: the reference's sorted
    keys)."""
    return torch.load(os.path.join(tmp, f"params_{name}.pt"))


def _port_order(name, tree):
    """``tree`` in the key order of the port's own init."""
    return tree_map(lambda _, t: t, step_mod.abstract_params(_cfg(name)), tree)


class _RankMesh:
    """A mesh's shape seen from one rank (its coordinate): enough for the
    spec rules and ``sharding.shard_tensor``."""

    def __init__(self, shape, coordinate):
        self.axis_names = DM
        self.shape = dict(zip(DM, shape))
        self.coordinate = coordinate

    axes, size, index = Mesh.axes, Mesh.size, Mesh.index


def _flat_specs(tree):
    """A spec tree as ``(is Halves, tuple)`` leaves: the ranks send their
    specs back through ``torch.load``, which takes tuples, not classes."""
    return tree_map(lambda s: (isinstance(s, S.Halves), tuple(s)), tree)


def _spec_leaves(tree) -> list:
    """The leaves of a ``_flat_specs`` tree as specs again."""
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _spec_leaves(v)]
    return [(S.Halves if tree[0] else S.P)(*tree[1])]


def _record_grads(step) -> list:
    """``step.grads`` made to keep a copy of each call's reduced gradients:
    the list of them, one per step (the step's own, not a second
    forward)."""
    seen, inner = [], step.grads

    def grads(state, batch):
        out = inner(state, batch)
        seen.append([g.clone() for g in out[3]])
        return out

    step.grads = grads
    return seen


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach().clone()


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _step_case(cfg_name, overrides, shape, tmp):
    from repro_torch.launch.mesh import make_mesh

    cfg = _cfg(cfg_name)
    mesh = make_mesh(shape, DM, device="cpu")
    step = make_train_step(cfg, _tcfg(**overrides), mesh, device="cpu")
    state = step.init_state(_params(cfg_name, tmp))
    grads = _record_grads(step)
    metrics = []
    for b in _batches(cfg, _steps(overrides)):
        local = step.shard_batch(b)
        state, m = step(state, local)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics, "grads": grads, "state": _detached(state),
            "specs": _flat_specs({k: step.state_specs[k] for k in state}),
            "coordinate": dict(mesh.coordinate),
            "model_collectives": step.last_collectives}


def _trainer_case(tmp, name, cfg_name, before, after):
    """Three steps on ``before`` uninterrupted, against: two with a
    checkpoint, then a fresh trainer on ``after`` restoring it and taking
    the third; and two steps, ``remesh(after)``, the third."""
    from repro_torch.launch.mesh import make_mesh

    cfg = _cfg(cfg_name)
    tcfg = _tcfg(fsdp=True, zero1=True, grad_compression="int8_ef")
    kw = dict(seq_len=SEQ, global_batch=BATCH, device="cpu")
    mesh_a, mesh_b = make_mesh(before, DM, device="cpu"), make_mesh(after, DM, device="cpu")
    ref = Trainer(cfg, tcfg, mesh_a, **kw)
    ref_losses = ref.train(STEPS).losses
    ref_full = _detached(ref.full_state())
    ckdir = os.path.join(tmp, f"ckpt_{name}")
    Trainer(cfg, tcfg, mesh_a, checkpoint_dir=ckdir, checkpoint_every=2, **kw).train(2)
    resumed = Trainer(cfg, tcfg, mesh_b, checkpoint_dir=ckdir, checkpoint_every=100, **kw)
    restored = resumed.restore_latest()
    resumed_losses = resumed.train(1).losses
    moved = Trainer(cfg, tcfg, mesh_a, **kw)
    moved.train(2)
    moved.remesh(mesh_b)
    moved_losses = moved.train(1).losses
    return {"ref_losses": ref_losses, "ref_full": ref_full, "restored": restored,
            "resumed_losses": resumed_losses, "resumed_full": _detached(resumed.full_state()),
            "moved_losses": moved_losses, "moved_full": _detached(moved.full_state())}


def _kv_seq(specs):
    """The dense cache's sequence entry (None: Mamba1 has no K/V)."""
    layers = specs["layers"]
    kv = layers.get("k", layers.get("shared_k"))
    return kv[2] if kv is not None else None


def _serve_case(tmp, name, cname, shape, batch):
    from repro_torch.launch.mesh import make_mesh

    cfg = _cfg(cname)
    mesh = make_mesh(shape, DM, device="cpu")
    data = torch.load(os.path.join(tmp, f"serve_{name}.pt"))
    sshape = ShapeConfig(name, SERVE_SEQ, batch, "decode")
    pre = step_mod.make_prefill_step(cfg, mesh, sshape, compute_dtype=torch.float32)
    dec = step_mod.make_serve_step(cfg, mesh, sshape, compute_dtype=torch.float32)
    local = pre.shard_params(data["params"])
    logits, cache = pre.step(local, pre.shard_inputs(data["inputs"]))
    plan = S.ShardingPlan(cfg, mesh)
    logits_spec = S.P(dec.input_specs[0] if len(dec.input_specs) else None, plan.vocab())
    local_shapes = tree_map(lambda t: tuple(t.shape), cache["layers"])
    out = {"prefill_logits": pre.gather_output(logits), "logits": [], "tokens": [],
           "local_shapes": local_shapes, "seq_entry": _kv_seq(pre.out_specs[1])}
    tok = S.shard_tensor(torch.argmax(out["prefill_logits"], -1).to(torch.int32),
                         dec.input_specs, mesh)
    for _ in range(DECODE_STEPS):
        lg = _decode_logits(cfg, dec, mesh, local, tok, tree_map(torch.clone, cache))
        out["logits"].append(S.gather_tensor(lg, logits_spec, mesh))
        tok, cache = dec.step(local, tok, cache)
        out["tokens"].append(dec.gather_output(tok))
    out["collectives"] = dict(mesh.collectives)
    full = dec.gather_cache(cache)
    out["cache"] = full["layers"]
    again = dec.shard_cache(full)
    out["reshard_equal"] = all(torch.equal(a, b) for a, b in
                               zip(tree_leaves(again["layers"]), tree_leaves(cache["layers"])))
    return out


def _decode_logits(cfg, dec, mesh, params, tokens, cache):
    """This rank's vocab columns of the logits ``dec.step`` takes its
    argmax of: ``T.decode_step`` under the step's activation specs and
    sequence axes, on the step's local index."""
    index = cache["index"]
    if index.ndim == 1 and dec.batch_sharded:
        index = S.shard_tensor(index, dec.input_specs, mesh)
    specs = S.activation_specs(cfg, mesh, batch_sharded=dec.batch_sharded)
    with torch.no_grad(), activation_sharding(mesh, specs, cache_seq=_kv_seq(dec.cache_specs)):
        logits, _ = T.decode_step(cfg, params, tokens, dict(cache, index=index),
                                  compute_dtype=torch.float32)
    return logits


def _placement(mesh):
    """For both families and every ``PLACEMENTS`` entry: whether shard ->
    gather of every param and moment leaf is bit-equal, and how many leaves
    split over ``model`` as ``Halves``."""
    out = {}
    for cname in ARCHS:
        cfg = _cfg(cname)
        params = T.init_params(cfg, torch.Generator().manual_seed(5))
        for layout, fsdp, zero1 in PLACEMENTS:
            specs = {"params": S.param_specs(cfg, params, mesh=mesh, fsdp=fsdp, layout=layout),
                     "mu": S.opt_state_specs(cfg, params, zero1, mesh, fsdp=fsdp,
                                             layout=layout)["mu"]}
            equal, halves = [], 0
            for key, tree in specs.items():
                for t, sp in zip(tree_leaves(params), tree_leaves(tree)):
                    back = S.gather_tensor(S.shard_tensor(t, sp, mesh).clone(), sp, mesh)
                    equal.append(torch.equal(back, t))
                    halves += isinstance(sp, S.Halves) and "model" in sp
            out[(cname, layout, fsdp, zero1)] = (all(equal), len(equal), halves)
    return out


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    S.FSDP_MIN_ELEMENTS = FSDP_MIN
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        from repro_torch.launch.mesh import make_mesh

        out = {"steps": {name: _step_case(c, kw, shape, tmp)
                         for name, c, kw, shape in STEP_CASES[world]},
               "serve": {name: _serve_case(tmp, name, c, shape, b)
                         for name, c, shape, b in SERVE_CASES[world]}}
        shapes = [(1, 2)] if world == 2 else [(1, 4), (2, 2)]
        out["placement"] = {shape: _placement(make_mesh(shape, DM, device="cpu"))
                            for shape in shapes}
        if world == 4:
            out["trainer"] = {name: _trainer_case(tmp, name, c, a, b)
                              for name, c, a, b in REMESH_CASES}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the test process: the reference, the single-device step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_grads(name):
    """The reference's loss and gradients on the case's weights and first
    batch: the mean over its two halves (``_microbatch_split`` into 2), as
    its ``make_train_step`` takes them at two microbatches.  At one
    microbatch the whole batch's mean loss and gradient are the same mean
    (the halves hold equal counts of tokens), so one compiled function of
    the half batch serves every case of a config."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import transformer as JT
    from repro.runtime.step import _microbatch_split

    jcfg = _cfg(name, jconfigs)
    batch = _batches(_cfg(name), 1)[0]
    params = jax.tree.map(jnp.asarray, _np_params(name))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, x, y: JT.lm_loss(jcfg, p, x, y, impl="xla", compute_dtype=jnp.float32),
        has_aux=True))
    xs, ys = (_microbatch_split(jnp.asarray(batch[k]), 2) for k in ("inputs", "labels"))
    losses, grads = [], None
    for j in range(2):
        (loss, _), g = grad_fn(params, xs[j], ys[j])
        losses.append(float(loss))
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return float(np.mean(losses)), jax.tree.map(lambda t: t / 2, grads)


@functools.lru_cache(maxsize=None)
def _reference_first_step(name, int8):
    """The reference's first step: (loss, grad norm -- after int8 error
    feedback from a zero residual under ``int8`` --, the gradients as the
    port's leaves)."""
    import jax
    import jax.numpy as jnp

    from repro.optim import clip_by_global_norm, ef_int8_compress_decompress

    loss, grads = _reference_grads(name)
    used = grads
    if int8:
        used = jax.tree.map(lambda t: ef_int8_compress_decompress(t, jnp.zeros_like(t))[0],
                            grads)
    _, gnorm = clip_by_global_norm(used, _tcfg().grad_clip_norm)
    leaves = tree_leaves(_port_order(name, params_from_numpy(jax.tree.map(np.asarray, grads),
                                                               device="cpu")))
    return loss, float(gnorm), leaves


def _serve_tokens(cname, batch):
    return np.random.default_rng(7).integers(0, _cfg(cname).vocab_size,
                                             (batch, PROMPT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_serve(cname, batch):
    """The reference's unsharded run on ``_serve_tokens``: prefill logits,
    then per decode step the logits and the greedy tokens, and the cache
    after them (every leaf, by path)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import transformer as JT

    jcfg = _cfg(cname, jconfigs)
    jparams = jax.tree.map(jnp.asarray, _np_params(cname))
    tokens = _serve_tokens(cname, batch)
    prefill = jax.jit(lambda p, x: JT.prefill(jcfg, p, x, SERVE_SEQ, compute_dtype=jnp.float32,
                                              cache_dtype=jnp.float32))
    decode = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, t, c, compute_dtype=jnp.float32))
    logits, cache = prefill(jparams, jnp.asarray(tokens))
    out = {"prefill_logits": np.asarray(logits), "logits": [], "tokens": []}
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(DECODE_STEPS):
        logits, cache = decode(jparams, tok, cache)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out["logits"].append(np.asarray(logits))
        out["tokens"].append(np.asarray(tok))
    out["cache"] = {}
    tree_map_with_path(lambda path, t: out["cache"].__setitem__(path, t),
                       jax.tree.map(np.asarray, cache["layers"]))
    return out


@functools.lru_cache(maxsize=None)
def _single_device_run(name, items, tmp):
    """The port's single-device step: per step the global batch's
    gradients (before error feedback), the metrics, the final state."""
    overrides = dict(items)
    cfg = _cfg(name)
    tcfg = _tcfg(**overrides)
    state = init_train_state(_port_order(name, _params(name, tmp)), tcfg)
    step = make_train_step(cfg, tcfg, device="cpu")
    metrics, grads = [], []
    inner = step_mod._loss_and_grads

    def recorded(*args, **kw):  # the step's own gradients, before error feedback
        out = inner(*args, **kw)
        grads.append([g.clone() for g in out[3]])
        return out

    step_mod._loss_and_grads = recorded
    try:
        for b in _batches(cfg, _steps(overrides)):
            state, m = step(state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        step_mod._loss_and_grads = inner
    return metrics, grads, _detached(state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(world)``: ``(tmp, the ranks' results)`` of the ``world``-rank
    spawn, run once per module; the reference's runs and the single-device
    steps of its cases are computed while the ranks run."""
    done = {}

    def get(world):
        if world in done:
            return done[world]
        tmp = tmp_path_factory.mktemp(f"ssm_tp{world}")
        names = {c[1] for c in STEP_CASES[world]} | {c[1] for c in SERVE_CASES[world]}
        if world == 4:
            names |= {c[1] for c in REMESH_CASES}
        for name in names:
            torch.save(params_from_numpy(_np_params(name), device="cpu"),
                       os.path.join(tmp, f"params_{name}.pt"))
        for name, cname, _, batch in SERVE_CASES[world]:
            torch.save({"params": params_from_numpy(_np_params(cname), device="cpu"),
                        "inputs": torch.as_tensor(_serve_tokens(cname, batch))},
                       os.path.join(tmp, f"serve_{name}.pt"))
        ctx = mp.start_processes(_worker, args=(world, str(tmp)), nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        try:
            for _, cname, _, batch in SERVE_CASES[world]:
                _reference_serve(cname, batch)
            for _, cname, kw, _ in STEP_CASES[world]:
                _reference_first_step(cname, kw.get("grad_compression") == "int8_ef")
                _single_device_run(cname, tuple(sorted(kw.items())), str(tmp))
        finally:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    pytest.fail(f"{world} ranks did not finish within {SPAWN_TIMEOUT_S} s")
        done[world] = tmp, [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]
        return done[world]
    return get


def _close(a, b, what, int8=False, err=False, adam=False):
    """Within ``RTOL`` of max |b| (int leaves equal); ``err``, the EF
    residual, against the quantizer's range, 254 max |b|.  ``int8``: up to
    ``FLIP_SHARE`` of the leaf a quantum apart.  ``adam``, parameters after
    AdamW steps: within ``ADAM_RTOL`` (an element whose first moment nearly
    cancels turns the gradients' last-digit differences, summed over
    ``model`` in another order, into a larger share of its update: a
    zero-initialised conv bias whose gradients agree within 3e-6 of their
    max ends three steps 1.6e-5 of its max apart)."""
    a, b = a.detach(), b.detach()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype == torch.int32:
        assert torch.equal(a, b), what
        return
    scale = b.float().abs().max() * (254 if err else 1)
    diff = (a.float() - b.float()).abs()
    off = int((diff > (ADAM_RTOL if adam else RTOL) * scale).sum())
    allowed = max(1, int(FLIP_SHARE * b.numel())) if int8 else 0
    assert off <= allowed, (what, off, float(diff.max()), float(b.abs().max()))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4], ids=["2ranks", "4ranks"])
def test_ssm_tp_step_matches_single_device(runs, world):
    """Losses, grad norms, every rank's gradient of every leaf at every
    step, and its parameter, moment (and error-feedback) blocks after the
    steps, against its blocks of the single-device run."""
    tmp, ranks = runs(world)
    for name, cname, kw, shape in STEP_CASES[world]:
        int8 = kw.get("grad_compression") == "int8_ef"
        want_metrics, want_grads, want_state = _single_device_run(
            cname, tuple(sorted(kw.items())), str(tmp))
        for r, res in enumerate(ranks):
            got = res["steps"][name]
            mesh = _RankMesh(shape, got["coordinate"])
            np.testing.assert_allclose(got["metrics"], want_metrics, rtol=RTOL, err_msg=name)
            specs = {k: _spec_leaves(v) for k, v in got["specs"].items()}
            assert any(isinstance(s, S.Halves) for s in specs["params"]), name
            for i, (g_got, g_want) in enumerate(zip(got["grads"], want_grads)):
                assert len(g_got) == len(g_want) == len(specs["params"]), name
                for j, (a, b, sp) in enumerate(zip(g_got, g_want, specs["params"])):
                    _close(a, S.shard_tensor(b, sp, mesh), (name, r, "grad", i, j))
            for key in want_state:
                got_leaves = tree_leaves(got["state"][key])
                for j, (a, b, sp) in enumerate(zip(got_leaves, tree_leaves(want_state[key]),
                                                   specs[key])):
                    _close(a, S.shard_tensor(b, sp, mesh), (name, r, key, j), int8=int8,
                           err=key == "err", adam=key == "params")
        assert ranks[0]["steps"][name]["model_collectives"].get("all_reduce", 0) > 0, name


@pytest.mark.parametrize("world", [2, 4], ids=["2ranks", "4ranks"])
def test_ssm_tp_first_step_matches_reference(runs, world):
    """Each case's first step on every rank against the reference's: loss,
    grad norm and the rank's block of every gradient."""
    _, ranks = runs(world)
    for name, cname, kw, shape in STEP_CASES[world]:
        loss, gnorm, grads = _reference_first_step(cname,
                                                   kw.get("grad_compression") == "int8_ef")
        for r, res in enumerate(ranks):
            got = res["steps"][name]
            mesh = _RankMesh(shape, got["coordinate"])
            got_loss, got_norm = got["metrics"][0]
            assert abs(got_loss - loss) <= REF_LOSS_ATOL, (name, r, got_loss, loss)
            np.testing.assert_allclose(got_norm, gnorm, rtol=RTOL, err_msg=f"{name} rank {r}")
            specs = _spec_leaves(got["specs"]["params"])
            assert len(got["grads"][0]) == len(grads) == len(specs), name
            for j, (a, b, sp) in enumerate(zip(got["grads"][0], grads, specs)):
                err = float((a - S.shard_tensor(b, sp, mesh)).abs().max())
                assert err <= REF_GRAD_RTOL * float(b.abs().max()), (name, r, j, err)


def test_ssm_checkpoint_restore_and_remesh_round_trip(runs):
    for name, *_ in REMESH_CASES:
        for res in runs(4)[1]:
            t = res["trainer"][name]
            assert t["restored"]
            np.testing.assert_allclose(t["resumed_losses"], t["ref_losses"][2:], rtol=RTOL)
            np.testing.assert_allclose(t["moved_losses"], t["ref_losses"], rtol=RTOL)
            for what in ("resumed_full", "moved_full"):
                for key in t["ref_full"]:
                    for j, (a, b) in enumerate(zip(tree_leaves(t[what][key]),
                                                   tree_leaves(t["ref_full"][key]))):
                        _close(a, b, (name, what, key, j), int8=True, err=key == "err")


@pytest.mark.parametrize("world", [2, 4], ids=["2ranks", "4ranks"])
def test_ssm_serve_steps_match_reference(runs, world):
    """Prefill + decode steps on the ranks' blocks against the reference's
    unsharded run: tokens equal, logits and every gathered cache leaf
    within ``RTOL`` of their max."""
    _, ranks = runs(world)
    for name, cname, shape, batch in SERVE_CASES[world]:
        ref = _reference_serve(cname, batch)
        for r, res in enumerate(ranks):
            got = res["serve"][name]

            def close(g, w, what):
                err = float(np.abs(g.numpy() - w).max())
                assert err <= RTOL * float(np.abs(w).max()), (name, r, what, err)

            close(got["prefill_logits"], ref["prefill_logits"], "prefill")
            for i in range(DECODE_STEPS):
                close(got["logits"][i], ref["logits"][i], ("decode", i))
                np.testing.assert_array_equal(got["tokens"][i].numpy(), ref["tokens"][i],
                                              err_msg=f"{name} rank {r} step {i}")
            paths = []
            tree_map_with_path(lambda path, t: paths.append((path, t)), got["cache"])
            assert sorted(p for p, _ in paths) == sorted(ref["cache"]), name
            for path, t in paths:
                close(t, ref["cache"][path], ("cache", path))
            assert got["reshard_equal"], (name, r)
        assert ranks[0]["serve"][name]["collectives"].get("all_reduce", 0) > 0, name


def test_ssm_serve_steps_run_on_local_blocks(runs):
    """Each rank's cache holds its ``d_inner`` block (Mamba1's conv window
    and h, Mamba2's conv_x and its heads of h; conv_bc whole); the 2-KV-head
    hybrid at model 4 splits its shared cache's sequence (8 of 32 rows a
    rank, both KV heads) and issues the partials' all-gathers."""
    _, ranks = runs(4)
    f, z = _cfg("falcon"), _cfg("zamba2")
    k = f.ssm_conv - 1
    for res in ranks:
        ssm = res["serve"]["ssm_serve_1x4"]["local_shapes"]
        assert ssm == {"conv": (f.num_layers, 4, k, f.d_inner // 4),
                       "h": (f.num_layers, 4, f.d_inner // 4, f.ssm_state)}
        seq = res["serve"]["hybrid_seq_serve_1x4"]
        n_cyc, every = z.num_layers // z.shared_attn_every, z.shared_attn_every
        assert seq["seq_entry"] == "model"
        assert seq["local_shapes"]["shared_k"] == (n_cyc, 4, SERVE_SEQ // 4, 2,
                                                   z.resolved_head_dim)
        assert seq["local_shapes"]["mamba"] == {
            "conv_x": (n_cyc, every, 4, k, z.d_inner // 4),
            "conv_bc": (n_cyc, every, 4, k, 2 * z.ssm_state),
            "h": (n_cyc, every, 4, z.ssm_num_heads // 4, z.ssm_head_dim, z.ssm_state)}
        assert seq["collectives"].get("all_gather", 0) > 0
        heads = res["serve"]["hybrid_serve_2x2"]["local_shapes"]["shared_k"]
        assert heads == (n_cyc, 2, SERVE_SEQ, z.num_kv_heads // 2, z.resolved_head_dim)


def test_placement_round_trips_bit_for_bit(runs):
    """shard -> gather of every param and moment leaf, both families, every
    layout, FSDP / ZeRO-1 on and off, on the (1, 2), (1, 4) and (2, 2)
    meshes: bit-equal; the paired leaves split over ``model`` on "tp"."""
    for world, shapes in ((2, [(1, 2)]), (4, [(1, 4), (2, 2)])):
        for res in runs(world)[1]:
            for shape in shapes:
                for key, (equal, n, halves) in res["placement"][shape].items():
                    assert equal and n > 0, (shape, key)
                    assert halves == (0 if key[1] == "dp256" else 2), (shape, key, halves)


@pytest.mark.parametrize("arch", ["falcon", "zamba2"])
def test_paired_halves_placement(arch):
    """A rank's block of ``in_proj`` / ``in_proj_zx`` is the r-th block of
    each half, ``[x_r | z_r]``, under a spec that equals the reference's as
    a tuple; every other leaf's split is the contiguous block."""
    cfg = _cfg(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    name = "in_proj" if arch == "falcon" else "in_proj_zx"
    full = params["layers"]["mixer"][name]
    for m in (2, 4):
        specs = S.param_specs(cfg, params, mesh=_RankMesh((1, m), {}))
        sp = specs["layers"]["mixer"][name]
        assert isinstance(sp, S.Halves) and tuple(sp) == (None,) * (sp.__len__() - 1) + ("model",)
        a, b = full.chunk(2, dim=-1)
        for r in range(m):
            mesh = _RankMesh((1, m), {"data": 0, "model": r})
            got = S.shard_tensor(full, sp, mesh)
            want = torch.cat([a.chunk(m, -1)[r], b.chunk(m, -1)[r]], -1)
            assert torch.equal(got, want), (m, r)
            conv = S.shard_tensor(params["layers"]["mixer"]["conv_w" if arch == "falcon"
                                                            else "conv_x_w"],
                                  specs["layers"]["mixer"]["conv_w" if arch == "falcon"
                                                           else "conv_x_w"], mesh)
            assert conv.shape[-1] == want.shape[-1] // 2


def test_mamba2_split_off_whole_heads_raises():
    """zamba2's smoke with SSM heads of 64 (2 heads of its 128 d_inner) at
    model 4: 32 columns a rank, half a head."""
    cfg = dataclasses.replace(_cfg("zamba2"), ssm_head_dim=64)
    with pytest.raises(ValueError, match="not whole SSM heads"):
        SSM.check_head_split(cfg, 4)
    SSM.check_head_split(cfg, 2)  # one head a rank
    mesh = _RankMesh((1, 4), {"data": 0, "model": 1})
    shape = ShapeConfig("t", SERVE_SEQ, 4, "decode")
    with pytest.raises(ValueError, match="not whole SSM heads"):
        step_mod.make_serve_step(cfg, mesh, shape, compute_dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    p = S.shard_tensor  # the rank's blocks of one layer's mixer
    specs = S.param_specs(cfg, params, mesh=mesh)
    layer = tree_map(lambda t, sp: p(t, sp, mesh)[0, 0], params["layers"]["mixer"],
                     specs["layers"]["mixer"])
    state = {"conv_x": torch.zeros((2, cfg.ssm_conv - 1, cfg.d_inner // 4)),
             "conv_bc": torch.zeros((2, cfg.ssm_conv - 1, 2 * cfg.ssm_state)),
             "h": torch.zeros((2, 1, cfg.ssm_head_dim, cfg.ssm_state))}
    with activation_sharding(mesh, S.activation_specs(cfg, mesh)):
        with pytest.raises(ValueError, match="not whole SSM heads"):
            SSM.mamba2_step(cfg, layer, torch.zeros((2, cfg.d_model)), state)
