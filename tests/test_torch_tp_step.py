"""Scale-out over the model axis, on the CPU over gloo: the port's
``ShardedTrainStep`` with ``layout="tp"`` at ``(data, model)`` = (1, 2),
(1, 4) and (2, 2) against its single-device step on the same global
batches -- Megatron TP (the dense qwen3 smoke: at model 4 its q heads split
and its 2 KV heads do not, so each rank reads the KV head of its q head),
expert parallelism (the moonshot smoke's 4 experts over ``model``), an
``embed_inputs`` config (the musicgen smoke) and a 6-head / 2-KV-head
config through ``padded_for_tp(4)`` (8 physical heads, masked slots split
across ranks); under FSDP, ZeRO-1, microbatches and int8 error feedback;
and a checkpoint -> restore / ``remesh`` round trip between (1, 4) and
(2, 2).

One spawn of 2 ranks and one of 4 (the (1, 4) and (2, 2) meshes in turn)
write their results to ``tmp_path``; the test process compares them.  Each
rank pins torch to one thread and joins the group through a ``FileStore``
in ``tmp_path``, with FSDP's size floor lowered to 1024 elements so the
smoke leaves shard (``tests/test_torch_dist_step.py``'s settings).

The invariant held: after the backward, every rank's gradient of every
leaf equals its block of the single-device gradient (``step.grads``, at
every step), and so do its parameters and AdamW moments after three steps
(one under int8 error feedback: ``_steps``); losses and grad norms equal the single-device step's.  Tolerance
(fp32): 1e-5 of the leaf's max |value| (the collectives sum in another
order); under int8 error feedback an element on a quantization boundary
may land one quantum apart (``FLIP_SHARE`` of a leaf).

Each case's first step is also held to the reference: its loss, grad norm
and every rank's gradient blocks against ``jax.value_and_grad`` of the
reference's ``lm_loss`` (``impl="xla"``), microbatched, error-fed and
clipped as the reference's ``make_train_step`` does (without its mesh,
which fails on this JAX; ``tests/test_torch_train.py``'s composition), on
the same numpy weights (``bridge.params_from_numpy``: every run of this
file starts from them) and batch, at ``tests/test_torch_train.py``'s
tolerances: loss within 1e-5, grad norm within 1e-5 relative, each
gradient within 1e-4 of its leaf's max |g|.  Remat changes no value of the
reference's, so it runs without.  The reference runs once per (config,
microbatches, compression) in the test process; the ranks do not load JAX.
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
from repro_torch.data import SyntheticDataset
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.runtime import Trainer, init_train_state, make_train_step
from repro_torch.runtime import sharding as S
from repro_torch.runtime import step as step_mod
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

RTOL = 1e-5
#: against the reference (``tests/test_torch_train.py``'s): the loss
#: absolute, each gradient relative to its leaf's max |g|
REF_LOSS_ATOL, REF_GRAD_RTOL = 1e-5, 1e-4
FLIP_SHARE = 1e-3
STEPS = 3
SEQ, BATCH = 16, 4
SPAWN_TIMEOUT_S = 150
FSDP_MIN = 1024
DM = ("data", "model")
#: (case name, config name, TrainConfig overrides, mesh shape)
STEP_CASES = {
    2: [
        ("dense_tp2", "qwen3", dict(), (1, 2)),
        ("dense_tp2_remat_full", "qwen3", dict(remat_policy="full"), (1, 2)),
        ("moe_ep2_remat_dots", "moonshot", dict(remat_policy="dots"), (1, 2)),
        ("moe_ep2_zero1", "moonshot", dict(zero1=True), (1, 2)),
        ("audio_tp2_micro2", "musicgen", dict(microbatches=2), (1, 2)),
        ("padded_tp2_int8", "padded", dict(grad_compression="int8_ef"), (1, 2)),
    ],
    4: [
        ("dense_tp4_zero1", "qwen3", dict(zero1=True), (1, 4)),
        ("moe_ep4_micro2", "moonshot", dict(microbatches=2), (1, 4)),
        ("padded_tp4", "padded", dict(), (1, 4)),
        ("audio_tp4_int8", "musicgen", dict(grad_compression="int8_ef"), (1, 4)),
        ("dense_2x2_fsdp_zero1", "qwen3", dict(fsdp=True, zero1=True), (2, 2)),
        ("moe_2x2_fsdp_int8_micro2", "moonshot",
         dict(fsdp=True, zero1=True, grad_compression="int8_ef", microbatches=2), (2, 2)),
        ("padded_2x2_fsdp", "padded", dict(fsdp=True), (2, 2)),
    ],
}
#: Trainer round trips on 4 ranks: (name, mesh before, mesh after)
REMESH_CASES = [("tp4_to_2x2", (1, 4), (2, 2)), ("2x2_to_tp4", (2, 2), (1, 4))]


ARCHS = {"qwen3": "qwen3-1.7b", "moonshot": "moonshot-v1-16b-a3b",
         "musicgen": "musicgen-large"}


def _cfg(name, package=configs):
    """A case's config, of the port (or, ``package``, of the reference)."""
    if name in ARCHS:
        return package.smoke_config(ARCHS[name])
    base = package.smoke_config("qwen3-1.7b")  # 6 q heads over 2 KV heads, padded to 8
    return dataclasses.replace(base, name="tiny-6h-kv2", num_heads=6,
                               num_kv_heads=2).padded_for_tp(4)


def _tcfg(**kw) -> TrainConfig:
    base = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, compute_dtype="float32",
                zero1=False, fsdp=False)
    base.update(kw)
    return TrainConfig(**base)


def _batches(cfg, n=STEPS):
    ds = SyntheticDataset(cfg=cfg, seq_len=SEQ, global_batch=BATCH, seed=0)
    return [ds.next_batch() for _ in range(n)]


def _steps(overrides) -> int:
    """Steps a case compares: under int8 error feedback one (an element on
    a quantization boundary may land one quantum apart, and Adam turns
    that into a weight moved by up to the learning rate, so the later
    steps would run on other weights), else ``STEPS``."""
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
    """``tree`` in the key order of the port's own init, which the sharded
    step's spec trees follow."""
    return tree_map(lambda _, t: t, step_mod.abstract_params(_cfg(name)), tree)


@functools.lru_cache(maxsize=None)
def _reference_grads(name, micro):
    """The reference's loss and gradients on the case's weights and first
    batch, microbatched as its ``make_train_step`` does."""
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
    xs, ys = (_microbatch_split(jnp.asarray(batch[k]), micro) for k in ("inputs", "labels"))
    losses, grads = [], None
    for j in range(micro):
        (loss, _), g = grad_fn(params, xs[j], ys[j])
        losses.append(float(loss))
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return float(np.mean(losses)), jax.tree.map(lambda t: t / micro, grads)


def _reference_first_step(name, micro, int8):
    """The reference's first step: (loss, grad norm -- after int8 error
    feedback from a zero residual under ``int8``, as its step clips --, the
    gradients before it as the port's leaves)."""
    import jax
    import jax.numpy as jnp

    from repro.optim import clip_by_global_norm, ef_int8_compress_decompress

    loss, grads = _reference_grads(name, micro)
    used = grads
    if int8:
        used = jax.tree.map(lambda t: ef_int8_compress_decompress(t, jnp.zeros_like(t))[0],
                            grads)
    _, gnorm = clip_by_global_norm(used, _tcfg().grad_clip_norm)
    leaves = tree_leaves(_port_order(name, params_from_numpy(jax.tree.map(np.asarray, grads),
                                                               device="cpu")))
    return loss, float(gnorm), leaves


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


def _step_case(cfg_name, overrides, shape, tmp):
    from repro_torch.launch.mesh import make_mesh

    cfg = _cfg(cfg_name)
    mesh = make_mesh(shape, DM, device="cpu")
    step = make_train_step(cfg, _tcfg(**overrides), mesh, device="cpu")
    state = step.init_state(_params(cfg_name, tmp))
    grads = _record_grads(step)
    metrics, counts = [], []
    for b in _batches(cfg, _steps(overrides)):
        local = step.shard_batch(b)
        state, m = step(state, local)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        counts.append(step.last_collectives)
    model_split = sum("model" in [a for e in s for a in (e if isinstance(e, tuple) else (e,))]
                      for s in tree_leaves(step.state_specs["params"]))
    return {"metrics": metrics, "grads": grads, "state": _detached(state),
            "specs": tree_map(tuple, {k: step.state_specs[k] for k in state}),
            "collectives": counts,
            "coordinate": dict(mesh.coordinate), "model_split": model_split}


def _trainer_case(tmp, name, before, after):
    """Three steps on ``before`` uninterrupted, against: two with a
    checkpoint, then a fresh trainer on ``after`` restoring it and taking
    the third; and two steps, ``remesh(after)``, the third."""
    from repro_torch.launch.mesh import make_mesh

    cfg = _cfg("qwen3")
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


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    S.FSDP_MIN_ELEMENTS = FSDP_MIN
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        out = {"steps": {name: _step_case(c, kw, shape, tmp)
                         for name, c, kw, shape in STEP_CASES[world]}}
        if world == 4:
            out["trainer"] = {name: _trainer_case(tmp, name, a, b)
                              for name, a, b in REMESH_CASES}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp) -> list:
    """Run the ``world`` ranks; while they run, the single-device steps and
    the reference's first steps of their cases (cached for the tests)."""
    ctx = mp.start_processes(_worker, args=(world, str(tmp)), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        for _, cname, kw, _ in STEP_CASES[world]:
            _single_device_run(cname, tuple(sorted(kw.items())), str(tmp))
            _reference_grads(cname, kw.get("microbatches", 1))
    finally:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"{world} ranks did not finish within {SPAWN_TIMEOUT_S} s")
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(world)``: the ranks' results of the ``world``-rank spawn (run
    once per module)."""
    done = {}

    def get(world):
        if world not in done:
            tmp = tmp_path_factory.mktemp(f"tp{world}")
            for name in {case[1] for case in STEP_CASES[world]}:
                torch.save(params_from_numpy(_np_params(name), device="cpu"),
                           os.path.join(tmp, f"params_{name}.pt"))
            done[world] = tmp, _spawn(world, tmp)
        return done[world]
    return get


class _RankMesh:
    """A mesh's shape seen from one rank (its coordinate): enough for
    ``sharding.shard_tensor``."""

    def __init__(self, shape, coordinate):
        self.axis_names = DM
        self.shape = dict(zip(DM, shape))
        self.coordinate = coordinate

    axes, size, index = Mesh.axes, Mesh.size, Mesh.index


def _close(a, b, what, int8=False, err=False):
    """Within ``RTOL`` of max |b| (int leaves equal); ``err``, the EF
    residual (at most half a quantum, ~max|g| / 254), against the
    quantizer's range, 254 max |b| (``test_torch_dist_step``'s rule)."""
    a, b = a.detach(), b.detach()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype == torch.int32:
        assert torch.equal(a, b), what
        return
    scale = b.float().abs().max() * (254 if err else 1)
    off = int(((a.float() - b.float()).abs() > RTOL * scale).sum())
    allowed = max(1, int(FLIP_SHARE * b.numel())) if int8 else 0
    assert off <= allowed, (what, off, float((a - b).abs().max()), float(b.abs().max()))


@pytest.mark.parametrize("world", [2, 4], ids=["2ranks", "4ranks"])
def test_tp_step_matches_single_device(runs, world):
    """Losses, grad norms, every rank's gradient of every leaf at every step,
    and its parameter, moment (and error-feedback) blocks after three steps,
    against its blocks of the single-device run."""
    tmp, ranks = runs(world)
    for name, cname, kw, shape in STEP_CASES[world]:
        int8 = kw.get("grad_compression") == "int8_ef"
        want_metrics, want_grads, want_state = _single_device_run(
            cname, tuple(sorted(kw.items())), str(tmp))
        for r, res in enumerate(ranks):
            got = res["steps"][name]
            mesh = _RankMesh(shape, got["coordinate"])
            np.testing.assert_allclose(got["metrics"], want_metrics, rtol=RTOL, err_msg=name)
            specs = tree_leaves(got["specs"]["params"])
            for i, (g_got, g_want) in enumerate(zip(got["grads"], want_grads)):
                for j, (a, b, sp) in enumerate(zip(g_got, g_want, specs)):
                    _close(a, S.shard_tensor(b, sp, mesh), (name, r, "grad", i, j))
            for key in want_state:
                for j, (a, b, sp) in enumerate(zip(tree_leaves(got["state"][key]),
                                                   tree_leaves(want_state[key]),
                                                   tree_leaves(got["specs"][key]))):
                    _close(a, S.shard_tensor(b, sp, mesh), (name, r, key, j), int8=int8,
                           err=key == "err")
        counts = ranks[0]["steps"][name]["collectives"]
        assert all(c == counts[0] for c in counts), (name, counts)
        assert ranks[0]["steps"][name]["model_split"] > 0, name


@pytest.mark.parametrize("world", [2, 4], ids=["2ranks", "4ranks"])
def test_tp_first_step_matches_reference(runs, world):
    """Each case's first step on every rank against the reference's: loss,
    grad norm and the rank's block of every gradient."""
    _, ranks = runs(world)
    for name, cname, kw, shape in STEP_CASES[world]:
        loss, gnorm, grads = _reference_first_step(
            cname, kw.get("microbatches", 1), kw.get("grad_compression") == "int8_ef")
        for r, res in enumerate(ranks):
            got = res["steps"][name]
            mesh = _RankMesh(shape, got["coordinate"])
            got_loss, got_norm = got["metrics"][0]
            assert abs(got_loss - loss) <= REF_LOSS_ATOL, (name, r, got_loss, loss)
            np.testing.assert_allclose(got_norm, gnorm, rtol=RTOL, err_msg=f"{name} rank {r}")
            specs = tree_leaves(got["specs"]["params"])
            assert len(got["grads"][0]) == len(grads) == len(specs), name
            for j, (a, b, sp) in enumerate(zip(got["grads"][0], grads, specs)):
                want = S.shard_tensor(b, sp, mesh)
                err = float((a - want).abs().max())
                assert err <= REF_GRAD_RTOL * float(b.abs().max()), (name, r, j, err)


def test_tp_checkpoint_restore_and_remesh_round_trip(runs):
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


def test_ranks_start_from_a_tree_in_another_key_order():
    """The ranks load the bridge's trees, whose keys run in the reference's
    sorted order, not in the port's: the sharded step pairs each leaf with
    its spec by key, so its results above hold whatever the order."""
    def paths(tree):
        out = []
        tree_map_with_path(lambda path, _: out.append(path), tree)
        return out

    for name in ("qwen3", "moonshot"):
        bridged = params_from_numpy(_np_params(name), device="cpu")
        assert sorted(paths(bridged)) == sorted(paths(_port_order(name, bridged)))
        assert paths(bridged) != paths(_port_order(name, bridged)), name


def test_padded_for_tp_matches_reference():
    from repro import configs as jconfigs

    for arch in configs.ARCH_IDS:
        for tp in (2, 4, 16):
            assert (configs.get_config(arch).padded_for_tp(tp).num_heads_physical
                    == jconfigs.get_config(arch).padded_for_tp(tp).num_heads_physical), (arch, tp)
    cfg = _cfg("padded")
    assert (cfg.num_heads, cfg.num_heads_physical) == (6, 8)


def test_gqa_split_that_does_not_align_raises():
    """6 q heads over 2 KV heads (groups of 3) split 3 ways: each rank's 2 q
    heads straddle a group, which no KV slice serves."""
    from repro_torch.models import layers as L
    from repro_torch.models.act_sharding import activation_sharding

    cfg = dataclasses.replace(configs.smoke_config("qwen3-1.7b"), num_heads=6, num_kv_heads=2)
    mesh = _RankMesh((1, 3), {"data": 0, "model": 1})
    specs = S.activation_specs(cfg, mesh)
    p = {"wq": torch.zeros((cfg.d_model, 2, 16))}
    k = v = torch.zeros((1, 4, 2, 16))
    with activation_sharding(mesh, specs):
        with pytest.raises(ValueError, match="split its GQA groups"):
            L._local_kv(cfg, p, k, v)
    aligned = dataclasses.replace(cfg, num_heads=4)  # 2 q heads a rank inside one group of 2
    with activation_sharding(_RankMesh((1, 2), {"data": 0, "model": 1}),
                             S.activation_specs(aligned, _RankMesh((1, 2), {}))):
        got = L._local_kv(aligned, p, torch.arange(2.0).reshape(1, 1, 2, 1), k)
    assert got[0].flatten().tolist() == [1.0]
