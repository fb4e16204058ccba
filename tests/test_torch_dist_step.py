"""Scale-out over the data axis, on the CPU over gloo: the port's
``ShardedTrainStep`` on 1, 2 and 4 ranks against its single-device step on
the same global batches, ``compressed_psum`` against the reference's
arithmetic, and the ``Trainer``'s checkpoint / restore / ``remesh`` round
trips against the uninterrupted run.

One spawn per rank count runs every case of that count (``_worker``) and
writes its results to ``tmp_path``; the test process compares them.  Each
rank pins torch to one thread and joins the group through a ``FileStore``
in ``tmp_path``.  The workers lower ``runtime.sharding.FSDP_MIN_ELEMENTS``
to 1024 so that the smoke configs' leaves (16K elements at most) shard
under FSDP; the rule is otherwise the reference's.

Tolerance: at world size 1 every number is bit-equal.  On 2 and 4 ranks
the step computes in fp32 and sums the gradient in another order (each
rank's mean over its rows, then the mean over ranks; the norm over
shards), so losses, gradient norms, parameters and moments are held to
``RTOL`` (max |a - b| over max |b|, per leaf) after three steps.
"""
from __future__ import annotations

import functools
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.configs import TrainConfig
from repro_torch.data import SyntheticDataset
from repro_torch.models import transformer as T
from repro_torch.runtime import Trainer, init_train_state, make_train_step
from repro_torch.runtime import sharding as S
from repro_torch.tree import tree_leaves

RTOL = 1e-5
#: int8 error feedback: the share of a leaf's elements that may sit one
#: quantization step apart after three steps (``_close_trees``)
FLIP_SHARE = 1e-3
STEPS = 3
SEQ, BATCH = 16, 8
SPAWN_TIMEOUT_S = 150
#: the FSDP size threshold the workers use (the reference's is 1 << 20)
FSDP_MIN = 1024
#: (case name, arch, TrainConfig overrides, mesh shape, mesh axes)
STEP_CASES = {
    2: [
        ("dense_plain", "qwen3-1.7b", dict(fsdp=False), (2, 1), ("data", "model")),
        ("dense_zero1", "qwen3-1.7b", dict(fsdp=False, zero1=True), (2, 1), ("data", "model")),
        ("dense_fsdp", "qwen3-1.7b", dict(fsdp=True), (2, 1), ("data", "model")),
        ("dense_fsdp_zero1", "qwen3-1.7b", dict(fsdp=True, zero1=True), (2, 1),
         ("data", "model")),
        ("dense_micro2", "qwen3-1.7b", dict(fsdp=True, zero1=True, microbatches=2), (2, 1),
         ("data", "model")),
        ("dense_int8", "qwen3-1.7b", dict(fsdp=True, zero1=True, grad_compression="int8_ef"),
         (2, 1), ("data", "model")),
        ("moe_fsdp_zero1", "moonshot-v1-16b-a3b", dict(fsdp=True, zero1=True), (2, 1),
         ("data", "model")),
    ],
    4: [
        ("dense_fsdp_zero1_d4", "qwen3-1.7b", dict(fsdp=True, zero1=True), (4, 1),
         ("data", "model")),
        ("moe_int8_micro2_d4", "moonshot-v1-16b-a3b",
         dict(fsdp=True, zero1=True, microbatches=2, grad_compression="int8_ef"), (4, 1),
         ("data", "model")),
        ("dense_dp256_2x2", "qwen3-1.7b", dict(fsdp=True, zero1=True, layout="dp256"), (2, 2),
         ("data", "model")),
        ("moe_dp256_2x2", "moonshot-v1-16b-a3b", dict(fsdp=True, layout="dp256"), (2, 2),
         ("data", "model")),
        ("dense_pod2_data2", "qwen3-1.7b", dict(fsdp=True, zero1=True), (2, 2),
         ("pod", "data")),
    ],
}
#: Trainer round trips: (name, layout, mesh before, mesh after) as (shape, axes)
REMESH_CASES = {
    2: [("data2_to_pod2", "tp", ((2, 1), ("data", "model")), ((2, 1), ("pod", "data")))],
    4: [("data4_to_pod2_data2", "tp", ((4, 1), ("data", "model")), ((2, 2), ("pod", "data"))),
        ("dp256_2x2_to_data4", "dp256", ((2, 2), ("data", "model")),
         ((4, 1), ("data", "model")))],
}


def _tcfg(**kw) -> TrainConfig:
    base = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, compute_dtype="float32",
                zero1=False, fsdp=False)
    base.update(kw)
    return TrainConfig(**base)


def _batches(cfg, n=STEPS):
    ds = SyntheticDataset(cfg=cfg, seq_len=SEQ, global_batch=BATCH, seed=0)
    return [ds.next_batch() for _ in range(n)]


def _params(cfg):
    return T.init_params(cfg, torch.Generator().manual_seed(0))


@functools.lru_cache(maxsize=None)
def _single_device_run(arch, items):
    """The port's single-device step over the same seed and batches."""
    cfg = configs.smoke_config(arch)
    tcfg = _tcfg(**dict(items))
    state = init_train_state(_params(cfg), tcfg)
    step = make_train_step(cfg, tcfg, device="cpu")
    metrics = []
    for b in _batches(cfg):
        state, m = step(state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, state


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach().clone()


def _step_case(arch, overrides, shape, axes):
    from repro_torch.launch.mesh import make_mesh

    cfg = configs.smoke_config(arch)
    tcfg = _tcfg(**overrides)
    mesh = make_mesh(shape, axes, device="cpu")
    step = make_train_step(cfg, tcfg, mesh, device="cpu")
    state = step.init_state(_params(cfg))
    metrics, counts = [], []
    for b in _batches(cfg):
        state, m = step(state, step.shard_batch(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        counts.append(step.last_collectives)
    full = step.gather_state(state)
    specs = {k: step.state_specs[k] for k in state}
    from repro_torch.runtime.sharding import shard_tensor

    exact = all(torch.equal(loc, shard_tensor(f, s, mesh))
                for loc, f, s in zip(tree_leaves(state), tree_leaves(full), tree_leaves(specs)))
    split = sum(any(e is not None for e in s) for s in tree_leaves(step.state_specs["params"]))
    return {"metrics": metrics, "full": _detached(full), "local_is_shard": exact,
            "collectives": counts, "param_leaves_split": split}


def _psum_case(rank, world):
    from repro_torch.optim import compressed_psum

    rng = np.random.default_rng(100 + rank)
    g = torch.tensor(rng.standard_normal((7, 33)).astype(np.float32))
    err = torch.tensor(rng.standard_normal((7, 33)).astype(np.float32) * 1e-3)
    summed, new_err = compressed_psum(g, err)
    return {"g": g, "err": err, "summed": summed, "new_err": new_err}


def _trainer_case(tmp, name, layout, before, after):
    """Three steps on ``before`` uninterrupted, against: two steps with a
    checkpoint, then a fresh trainer on ``after`` restoring it and taking
    the third; and two steps, ``remesh(after)``, the third."""
    from repro_torch.launch.mesh import make_mesh

    cfg = configs.smoke_config("qwen3-1.7b")
    tcfg = _tcfg(fsdp=True, zero1=True, grad_compression="int8_ef", layout=layout)
    kw = dict(seq_len=SEQ, global_batch=BATCH, device="cpu")
    mesh_a, mesh_b = make_mesh(*before, device="cpu"), make_mesh(*after, device="cpu")
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
    live = moved.state
    moved.remesh(mesh_b)
    moved_losses = moved.train(1).losses  # the report's, all three steps
    return {"ref_losses": ref_losses, "ref_full": ref_full, "restored": restored,
            "resumed_step": resumed.step_no, "resumed_losses": resumed_losses,
            "resumed_full": _detached(resumed.full_state()), "moved_losses": moved_losses,
            "moved_full": _detached(moved.full_state()), "same_dict": moved.state is live}


def _fused_case(world):
    """``make_collocated_step`` over the sharded step: the train result
    bit-equal to the step alone, the tokens to two eager decode steps."""
    from repro_torch.core import make_collocated_step
    from repro_torch.launch.mesh import make_dev_mesh

    cfg = configs.smoke_config("qwen3-1.7b")
    step = make_train_step(cfg, _tcfg(fsdp=True, zero1=True), make_dev_mesh(data=world,
                                                                           device="cpu"),
                           device="cpu")
    params = _params(cfg)

    def decode(p, t, c):
        return T.decode_step(cfg, p, t, c, compute_dtype=torch.float32)

    batch = step.shard_batch(_batches(cfg, 1)[0])
    alone, m_alone = step(step.init_state(params), batch)
    tokens = torch.tensor([1, 2], dtype=torch.int32)
    fused, m, toks, _ = make_collocated_step(step, decode, k_buckets=(2,))[2](
        step.init_state(params), batch, params, tokens,
        T.init_cache(cfg, 2, SEQ, torch.float32, device="cpu"))
    cache = T.init_cache(cfg, 2, SEQ, torch.float32, device="cpu")
    for _ in range(2):
        logits, cache = decode(params, tokens, cache)
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    return {"train_equal": all(torch.equal(a.detach(), b.detach()) for a, b in
                               zip(tree_leaves(fused), tree_leaves(alone)))
            and all(torch.equal(m[k], m_alone[k]) for k in m),
            "tokens_equal": toks.tolist() == tokens.tolist()}


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    from repro_torch.runtime import sharding

    sharding.FSDP_MIN_ELEMENTS = FSDP_MIN
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        out = {"steps": {name: _step_case(arch, kw, shape, axes)
                         for name, arch, kw, shape, axes in STEP_CASES[world]},
               "psum": _psum_case(rank, world),
               "fused": _fused_case(world),
               "trainer": {name: _trainer_case(tmp, name, layout, a, b)
                           for name, layout, a, b in REMESH_CASES[world]}}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp) -> list:
    """Run the ``world`` ranks; while they run, the single-device runs of
    their cases (cached for the tests)."""
    ctx = mp.start_processes(_worker, args=(world, str(tmp)), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        for _, arch, kw, _, _ in STEP_CASES[world]:
            _single_device_run(arch, tuple(sorted(kw.items())))
    finally:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"{world} ranks did not finish within {SPAWN_TIMEOUT_S} s")
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def spawned(request, tmp_path_factory):
    world = request.param
    return world, _spawn(world, tmp_path_factory.mktemp(f"dist{world}"))


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _close_trees(got, want, rtol, what, int8=False):
    """Every float leaf within ``rtol`` of ``max |want|`` (int leaves equal).
    Under int8 error feedback a gradient element whose ``g + err`` sits
    within rounding of a quantization boundary may land one quantum apart
    (the gradients' sums differ in the last bits): there at most
    ``FLIP_SHARE`` of a leaf's elements (at least one) may stand out, and
    ``err`` (at most half a quantum, ~max|g| / 254) is held to ``rtol`` of
    the quantizer's range, 254 max |err|."""
    for key in want:
        for i, (a, b) in enumerate(zip(tree_leaves(got[key]), tree_leaves(want[key]))):
            a, b = a.detach(), b.detach()
            assert a.shape == b.shape, (what, key, i, a.shape, b.shape)
            if a.dtype == torch.int32:
                assert torch.equal(a, b), (what, key, i)
                continue
            scale = b.float().abs().max() * (254 if key == "err" else 1)
            off = int(((a.float() - b.float()).abs() > rtol * scale).sum())
            allowed = max(1, int(FLIP_SHARE * b.numel())) if int8 else 0
            assert off <= allowed, (what, key, i, off, _rel(a.float(), b.float()))


# ---------------------------------------------------------------------------
# world size 1, in this process: bit-equal
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("overrides", [
    dict(fsdp=True, zero1=True),
    dict(fsdp=True, zero1=True, microbatches=2, grad_compression="int8_ef"),
    dict(fsdp=False, zero1=True, layout="dp256"),
], ids=["fsdp_zero1", "micro2_int8", "dp256"])
def test_world_size_one_is_bit_equal(one_rank_group, overrides):
    from repro_torch.launch.mesh import make_dev_mesh

    cfg = configs.smoke_config("qwen3-1.7b")
    tcfg = _tcfg(**dict(overrides, compute_dtype="bfloat16"))
    mesh = make_dev_mesh(device="cpu")
    sharded = make_train_step(cfg, tcfg, mesh, device="cpu")
    plain = make_train_step(cfg, tcfg, device="cpu")
    s_state = sharded.init_state(_params(cfg))
    p_state = init_train_state(_params(cfg), tcfg)
    for b in _batches(cfg):
        s_state, sm = sharded(s_state, sharded.shard_batch(b))
        p_state, pm = plain(p_state, b)
        for k in pm:
            assert torch.equal(sm[k], pm[k]), k
        assert sharded.last_collectives["all_reduce"] >= 3
        assert sharded.last_collectives.get("all_gather", 0) > 0  # ZeRO-1's gathers
    for a, b in zip(tree_leaves(s_state), tree_leaves(p_state)):
        assert torch.equal(a, b)


def test_sharded_path_refuses_what_it_cannot_run(one_rank_group):
    from repro_torch.launch.mesh import make_dev_mesh, make_mesh, make_production_mesh

    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_dev_mesh(data=2, device="cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device="cpu")
    cfg = configs.smoke_config("qwen3-1.7b")
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    mesh.shape["model"] = 2  # a stand-in for a 1x2 mesh: the rule reads the shape
    # "tp" over a model axis runs every family (its leaves split over
    # "model"); Mamba1 and the hybrid split d_inner, their paired in_proj
    # halves placed [x_r | z_r], and take a step (over this one-rank group
    # the model collectives are identities: tests/test_torch_ssm_model_axis.py
    # holds the steps over 2 and 4 ranks)
    step = make_train_step(cfg, _tcfg(), mesh, device="cpu")
    assert any("model" in s for s in tree_leaves(step.state_specs["params"]))
    for arch, paired in (("falcon-mamba-7b", "in_proj"), ("zamba2-2.7b", "in_proj_zx")):
        scfg = configs.smoke_config(arch)
        step = make_train_step(scfg, _tcfg(), mesh, device="cpu")
        specs = step.state_specs["params"]["layers"]["mixer"]
        assert isinstance(specs[paired], S.Halves) and specs[paired][-1] == "model"
        state = step.init_state(_params(scfg))
        di = state["params"]["layers"]["mixer"][paired].shape[-1] // 2
        assert di == scfg.d_inner // 2, arch
        state, m = step(state, step.shard_batch(_batches(scfg)[0]))
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"]), arch
        assert step.last_collectives["all_reduce"] > 0, arch
    with pytest.raises(ValueError, match="layout"):
        make_train_step(cfg, _tcfg(layout="tp2"), make_dev_mesh(device="cpu"), device="cpu")
    mesh = make_dev_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="cpu mesh"):
        mesh.all_reduce(torch.zeros(2, device="meta"), ("data",))


def test_mesh_needs_a_process_group():
    from repro_torch.launch.mesh import make_dev_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_dev_mesh(device="cpu")


# ---------------------------------------------------------------------------
# 2 and 4 ranks over gloo
# ---------------------------------------------------------------------------


def test_sharded_step_matches_single_device(spawned):
    world, ranks = spawned
    for name, arch, kw, shape, axes in STEP_CASES[world]:
        want_metrics, want_state = _single_device_run(arch, tuple(sorted(kw.items())))
        for r, res in enumerate(ranks):
            got = res["steps"][name]
            assert got["local_is_shard"], (name, r)
            np.testing.assert_allclose(got["metrics"], want_metrics, rtol=RTOL, err_msg=name)
            _close_trees(got["full"], want_state, RTOL, name,
                         int8=kw.get("grad_compression") == "int8_ef")
        counts = ranks[0]["steps"][name]["collectives"]
        assert all(c == counts[0] for c in counts), (name, counts)  # the same every step
        if kw.get("fsdp"):
            assert ranks[0]["steps"][name]["param_leaves_split"] > 0, name
            assert counts[0].get("reduce_scatter", 0) > 0, (name, counts[0])
        else:
            assert "reduce_scatter" not in counts[0], (name, counts[0])


def test_compressed_psum_matches_reference_arithmetic(spawned):
    import jax.numpy as jnp

    from repro.optim.compression import _quantize

    world, ranks = spawned
    total = None
    for res in ranks:
        p = res["psum"]
        g32 = jnp.asarray(p["g"].numpy()) + jnp.asarray(p["err"].numpy())
        q, scale = _quantize(g32)
        q, scale = np.asarray(q), np.float32(scale)
        np.testing.assert_array_equal(p["new_err"].numpy(),
                                      np.asarray(g32) - q.astype(np.float32) * scale)
        term = scale * q.astype(np.float32)
        total = term if total is None else total + term
    for res in ranks:
        np.testing.assert_array_equal(res["psum"]["summed"].numpy(), total)


def test_checkpoint_restore_and_remesh_round_trip(spawned):
    world, ranks = spawned
    for name, *_ in REMESH_CASES[world]:
        for res in ranks:
            t = res["trainer"][name]
            assert t["restored"] and t["resumed_step"] == STEPS
            np.testing.assert_allclose(t["resumed_losses"], t["ref_losses"][2:], rtol=RTOL)
            np.testing.assert_allclose(t["moved_losses"], t["ref_losses"], rtol=RTOL)
            assert t["same_dict"]
            _close_trees(t["resumed_full"], t["ref_full"], RTOL, name + " restored", int8=True)
            _close_trees(t["moved_full"], t["ref_full"], RTOL, name + " remeshed", int8=True)


def test_fused_step_over_the_sharded_step(spawned):
    _, ranks = spawned
    for res in ranks:
        assert res["fused"] == {"train_equal": True, "tokens_equal": True}
