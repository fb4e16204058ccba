"""The serve steps on a mesh against the reference: the port's
``make_serve_step`` / ``make_prefill_step`` spec trees leaf for leaf
against ``repro.runtime.step``'s for all 10 archs on the 16x16 and
2x16x16 meshes (a ``FakeMesh``: the builders read its shape alone); and,
over gloo at ``(data, model)`` = (1, 2), (1, 4) and (2, 2), a prefill plus
``DECODE_STEPS`` greedy decode steps on each rank's blocks against the
reference's unsharded ``T.prefill`` + ``T.decode_step`` (jitted, no mesh,
the reference's weights through ``params_from_numpy``, fp32): tokens
equal; the logits the step takes its argmax of (``T.decode_step`` under
the step's activation specs and sequence axes) and the cache gathered by
``gather_cache`` within ``RTOL`` of their max; ``shard_cache`` gives each
rank its blocks back.

The cases cover KV heads on ``model`` (the qwen3 smoke's 2 at model 2),
the sequence-parallel cache (its 2 KV heads at model 4: each rank a block
of 8 of the 32 rows, one block never written, #3's partial form merged),
expert parallelism (the moonshot smoke, its decode batch routed as one
group across the data axis), the stub frontend's embeddings (musicgen),
padded heads (6 over 2 KV heads through ``padded_for_tp(4)``) and a batch
of one, whose cache sequence rides ``(data, model)``.  Plus the partial
form's plain version: ``decode_partial_core`` over m blocks merged by
``combine_partials_core`` equals ``decode_core``.

One spawn of 2 ranks and one of 4 (each rank one torch thread, a
``FileStore`` in ``tmp_path``); the reference's weights and results are
computed once in the test process and shared through module fixtures.
JAX is imported only where the reference runs, so the spawned ranks do
not load it.
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

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import decode_attention as dd
from repro_torch.runtime import sharding as S
from repro_torch.runtime import step as step_mod

RTOL = 1e-5
SEQ, PROMPT, DECODE_STEPS = 32, 12, 8
SPAWN_TIMEOUT_S = 150
DM = ("data", "model")
#: (case name, config name, mesh shape, batch)
CASES = {
    2: [("dense_kvheads_1x2", "qwen3", (1, 2), 4), ("moe_ep_1x2", "moonshot", (1, 2), 4),
        ("audio_1x2", "musicgen", (1, 2), 4)],
    4: [("dense_seq_1x4", "qwen3", (1, 4), 4), ("padded_seq_1x4", "padded", (1, 4), 4),
        ("moe_ep_1x4", "moonshot", (1, 4), 4), ("dense_2x2", "qwen3", (2, 2), 4),
        ("moe_2x2", "moonshot", (2, 2), 4), ("batch1_2x2", "kv1", (2, 2), 1)],
}


def _cfgs(name):
    """(the port's config, the reference's) of a case."""
    if name in ("qwen3", "moonshot", "musicgen"):
        arch = {"qwen3": "qwen3-1.7b", "moonshot": "moonshot-v1-16b-a3b",
                "musicgen": "musicgen-large"}[name]
        return configs.smoke_config(arch), jconfigs.smoke_config(arch)
    kw = (dict(num_heads=6, num_kv_heads=2) if name == "padded"
          else dict(num_kv_heads=1))
    pair = [dataclasses.replace(c.smoke_config("qwen3-1.7b"), name=f"tiny-{name}", **kw)
            for c in (configs, jconfigs)]
    if name == "padded":
        pair = [c.padded_for_tp(4) for c in pair]
    return tuple(pair)


# ---------------------------------------------------------------------------
# spec trees on the production meshes
# ---------------------------------------------------------------------------


class FakeMesh:
    """Shape/axis-name stand-in (the builders read only these)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}
SPEC_CASES = [(a, s) for a in jconfigs.ARCH_IDS for s in ("decode_32k", "long_500k")
              if jconfigs.shape_applicable(jconfigs.get_config(a), jconfigs.get_shape(s))[0]]


@pytest.fixture(scope="module")
def ref_step(monkeypatch_module):
    """``repro.runtime.step`` with its full-size abstract trees built once
    per (arch, dtype, ...) for the module (the builders ask for them at
    every call); the port's likewise."""
    from repro.runtime import step as JS

    monkeypatch_module.setattr(JS, "abstract_params", functools.lru_cache(None)(
        JS.abstract_params))
    monkeypatch_module.setattr(JS, "abstract_cache", functools.lru_cache(None)(
        JS.abstract_cache))
    monkeypatch_module.setattr(step_mod, "abstract_params", functools.lru_cache(None)(
        step_mod.abstract_params))
    return JS


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp_ = pytest.MonkeyPatch()
    yield mp_
    mp_.undo()


def _flat(tree, prefix=""):
    """{path: spec as a tuple} of a spec tree (dicts, tuples, specs of either
    package)."""
    from jax.sharding import PartitionSpec as JP

    if isinstance(tree, (JP, S.P)):
        return {prefix: tuple(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", SPEC_CASES)
def test_serve_step_specs_match_reference(ref_step, arch, shape, mesh):
    jcfg, cfg, m = jconfigs.get_config(arch), configs.get_config(arch), MESHES[mesh]
    jshape, pshape = jconfigs.get_shape(shape), configs.SHAPES[shape]
    for jmake, make in ((ref_step.make_serve_step, step_mod.make_serve_step),
                        (ref_step.make_prefill_step, step_mod.make_prefill_step)):
        ref, got = jmake(jcfg, m, jshape), make(cfg, m, pshape)
        for field in ("param_specs", "input_specs", "cache_specs", "out_specs"):
            want = getattr(ref, field)
            have = getattr(got, field)
            if want is None:
                assert have is None, (field, have)
                continue
            assert _flat(have) == _flat(want), (arch, shape, mesh, jmake.__name__, field)


def test_serve_steps_refuse_what_they_cannot_run():
    cfg = configs.smoke_config("qwen3-1.7b")
    shape = ShapeConfig("t", SEQ, 4, "decode")
    # the compute dtype or an 8-bit cache (tests/test_torch_fp8_cache.py); a
    # float16 cache is a pair the port does not run
    with pytest.raises(NotImplementedError, match="float16"):
        step_mod.make_serve_step(cfg, MESHES["single"], shape, cache_dtype=torch.float16)
    art = step_mod.make_prefill_step(cfg, MESHES["single"], shape)
    assert art.cache_specs is None and art.abstract_inputs()[1].shape == (4, SEQ)
    # Mamba1 and the hybrid build their specs over a model axis and run
    # their steps there on rank 0's d_inner block (this stand-in's
    # collectives are identities that count their calls:
    # tests/test_torch_ssm_model_axis.py holds the steps over 2 and 4 ranks)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T

    class RankMesh(FakeMesh):
        coordinate = {"data": 0, "model": 0}
        axes, size, index = Mesh.axes, Mesh.size, Mesh.index

        def all_reduce(self, t, axes, op="sum"):
            self.calls += 1
            return t

        def all_gather(self, t, axes, dim):
            self.calls += 1
            return torch.cat([t] * self.size(axes), dim)

    for arch, state in (("falcon-mamba-7b", "conv"), ("zamba2-2.7b", "conv_x")):
        scfg = configs.smoke_config(arch)
        mesh = RankMesh({"data": 1, "model": 2})
        mesh.calls = 0
        pre = step_mod.make_prefill_step(scfg, mesh, shape, compute_dtype=torch.float32)
        dec = step_mod.make_serve_step(scfg, mesh, shape, compute_dtype=torch.float32)
        local = dec.shard_params(T.init_params(scfg, torch.Generator().manual_seed(0)))
        logits, cache = pre.step(local, torch.zeros((4, 6), dtype=torch.int32))
        tokens, cache = dec.step(local, torch.zeros((4,), dtype=torch.int32), cache)
        assert tokens.shape == (4,) and torch.isfinite(logits).all(), arch
        leaf = cache["layers"][state] if state in cache["layers"] else \
            cache["layers"]["mamba"][state]
        assert leaf.shape[-1] == scfg.d_inner // 2 and mesh.calls > 0, arch


# ---------------------------------------------------------------------------
# tokens and logits over gloo
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _weights(cname, batch):
    """The reference's weights (numpy) and prompt of a config and batch."""
    import jax

    from repro.models import transformer as JT

    _, jcfg = _cfgs(cname)
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (batch, PROMPT)).astype(np.int32)
    return np_params, np_params["embed"][tokens] if jcfg.embed_inputs else tokens


@functools.lru_cache(maxsize=None)
def _reference(cname, batch):
    """The reference's weights (numpy) and its unsharded run: prefill
    logits, then per decode step the logits and the greedy tokens (one run
    per config and batch, shared by the meshes)."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT

    _, jcfg = _cfgs(cname)
    np_params, inputs = _weights(cname, batch)
    jparams = jax.tree.map(jnp.asarray, np_params)
    prefill = jax.jit(lambda p, x: JT.prefill(jcfg, p, x, SEQ, compute_dtype=jnp.float32,
                                              cache_dtype=jnp.float32))
    decode = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, t, c, compute_dtype=jnp.float32))
    logits, cache = prefill(jparams, jnp.asarray(inputs))
    out = {"prefill_logits": np.asarray(logits), "logits": [], "tokens": []}
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(DECODE_STEPS):
        logits, cache = decode(jparams, tok, cache)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out["logits"].append(np.asarray(logits))
        out["tokens"].append(np.asarray(tok))
    out["cache"] = {name: np.asarray(cache["layers"][name]) for name in ("k", "v")}
    return np_params, inputs, out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _serve_case(tmp, name, cname, shape, batch):
    from repro_torch.launch.mesh import make_mesh

    cfg, _ = _cfgs(cname)
    mesh = make_mesh(shape, DM, device="cpu")
    data = torch.load(os.path.join(tmp, f"{name}.pt"))
    params = data["params"]
    sshape = ShapeConfig(name, SEQ, batch, "decode")
    pre = step_mod.make_prefill_step(cfg, mesh, sshape, compute_dtype=torch.float32)
    dec = step_mod.make_serve_step(cfg, mesh, sshape, compute_dtype=torch.float32)
    local = pre.shard_params(params)
    logits, cache = pre.step(local, pre.shard_inputs(data["inputs"]))
    plan = S.ShardingPlan(cfg, mesh)
    logits_spec = S.P(dec.input_specs[0] if len(dec.input_specs) else None, plan.vocab())
    out = {"prefill_logits": pre.gather_output(logits), "logits": [], "tokens": [],
           "kv_local": tuple(cache["layers"]["k"].shape), "seq_entry": pre.out_specs[1][
               "layers"]["k"][2]}
    tok = S.shard_tensor(torch.argmax(out["prefill_logits"], -1).to(torch.int32),
                         dec.input_specs, mesh)
    for _ in range(DECODE_STEPS):
        lg = _decode_logits(cfg, dec, mesh, local, tok, _clone(cache))
        out["logits"].append(S.gather_tensor(lg, logits_spec, mesh))
        tok, cache = dec.step(local, tok, cache)
        out["tokens"].append(dec.gather_output(tok))
    out["collectives"] = dict(mesh.collectives)
    # the helpers that move a cache between its full form and this rank's
    # blocks: the gathered cache is the reference's, and shards back to this
    # rank's
    full = dec.gather_cache(cache)
    out["cache"] = {name: full["layers"][name] for name in ("k", "v")}
    again = dec.shard_cache(full)
    out["reshard_equal"] = all(torch.equal(again["layers"][n], cache["layers"][n])
                               for n in ("k", "v"))
    return out


def _decode_logits(cfg, dec, mesh, params, tokens, cache):
    """This rank's vocab columns of the logits ``dec.step`` takes its
    argmax of: ``T.decode_step`` under the step's activation specs and
    sequence axes, on the step's local index."""
    from repro_torch.models import transformer as T
    from repro_torch.models.act_sharding import activation_sharding

    index = cache["index"]
    if index.ndim == 1 and dec.batch_sharded:
        index = S.shard_tensor(index, dec.input_specs, mesh)
    specs = S.activation_specs(cfg, mesh, batch_sharded=dec.batch_sharded)
    with torch.no_grad(), activation_sharding(mesh, specs,
                                              cache_seq=dec.cache_specs["layers"]["k"][2]):
        logits, _ = T.decode_step(cfg, params, tokens, dict(cache, index=index),
                                  compute_dtype=torch.float32)
    return logits


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    try:
        out = {name: _serve_case(tmp, name, c, shape, b) for name, c, shape, b in CASES[world]}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(world)``: ``(reference results by case, the ranks' results)``
    of the ``world``-rank spawn, run once per module."""
    done = {}

    def get(world):
        if world not in done:
            tmp = tmp_path_factory.mktemp(f"serve{world}")
            for case in CASES[world]:
                np_params, inputs = _weights(case[1], case[3])
                torch.save({"params": params_from_numpy(np_params, device="cpu"),
                            "inputs": torch.as_tensor(inputs)},
                           os.path.join(tmp, f"{case[0]}.pt"))
            ctx = mp.start_processes(_worker, args=(world, str(tmp)), nprocs=world,
                                     join=False, start_method="spawn")
            # the reference's runs while the ranks run
            refs = {case[0]: _reference(case[1], case[3])[2] for case in CASES[world]}
            deadline = time.monotonic() + SPAWN_TIMEOUT_S
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    pytest.fail(f"{world} ranks did not finish within {SPAWN_TIMEOUT_S} s")
            done[world] = refs, [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                                 for r in range(world)]
        return done[world]
    return get


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(got - want).max())
    assert err <= RTOL * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("world", [2, 4], ids=["2ranks", "4ranks"])
def test_serve_steps_match_reference(runs, world):
    refs, ranks = runs(world)
    for name, cname, shape, batch in CASES[world]:
        ref = refs[name]
        for r, res in enumerate(ranks):
            got = res[name]
            _close(got["prefill_logits"], ref["prefill_logits"], (name, r, "prefill"))
            for i in range(DECODE_STEPS):
                _close(got["logits"][i], ref["logits"][i], (name, r, "decode", i))
                np.testing.assert_array_equal(got["tokens"][i].numpy(), ref["tokens"][i],
                                              err_msg=f"{name} rank {r} step {i}")
            for kv in ("k", "v"):
                _close(got["cache"][kv], ref["cache"][kv], (name, r, "cache", kv))
            assert got["reshard_equal"], (name, r)
        assert ranks[0][name]["collectives"].get("all_reduce", 0) > 0, name


def test_sequence_parallel_cache_is_split(runs):
    """The qwen3 smoke's 2 KV heads at model 4 split the cache's sequence
    (8 of 32 rows a rank, every KV head); the batch of one rides (data,
    model)."""
    _, ranks = runs(4)
    for res in ranks:
        assert res["dense_seq_1x4"]["seq_entry"] == "model"
        assert res["dense_seq_1x4"]["kv_local"] == (2, 4, SEQ // 4, 2, 16)
        assert res["batch1_2x2"]["seq_entry"] == ("data", "model")
        assert res["batch1_2x2"]["kv_local"] == (2, 1, SEQ // 4, 1, 16)
        assert res["dense_2x2"]["kv_local"] == (2, 2, SEQ, 1, 16)  # batch on data, heads on model
        assert res["dense_seq_1x4"]["collectives"].get("all_gather", 0) > 0


# ---------------------------------------------------------------------------
# the partial form's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 4])
def test_partial_blocks_merge_to_decode_core(m):
    g = torch.Generator().manual_seed(m)
    b, s, h, kvh, hd = 5, 64, 8, 2, 16
    q = torch.randn((b, h, hd), generator=g)
    k = torch.randn((b, s, kvh, hd), generator=g)
    v = torch.randn((b, s, kvh, hd), generator=g)
    lengths = torch.tensor([0, 1, s // m, s // m + 3, s], dtype=torch.int32)  # empty blocks
    blk = s // m
    parts = [dd.decode_partial_core(q, k[:, r * blk:(r + 1) * blk], v[:, r * blk:(r + 1) * blk],
                                    (lengths - r * blk).clamp(0, blk))
             for r in range(m)]
    acc = torch.stack([p[0] for p in parts], 1)
    ml = torch.stack([p[1] for p in parts], 1)
    assert torch.equal(ml[..., 1][lengths == 0], torch.zeros_like(ml[..., 1][lengths == 0]))
    got = dd.combine_partials_core(acc, ml, torch.float32)
    want = dd.decode_core(q, k, v, lengths)
    assert float((got - want).abs().max()) <= 1e-6
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    # a NaN key poisons its row and no other
    kn = k.clone()
    kn[3, 2, 1, 5] = float("nan")
    parts = [dd.decode_partial_core(q, kn[:, r * blk:(r + 1) * blk], v[:, r * blk:(r + 1) * blk],
                                    (lengths - r * blk).clamp(0, blk)) for r in range(m)]
    got = dd.combine_partials_core(torch.stack([p[0] for p in parts], 1),
                                   torch.stack([p[1] for p in parts], 1), torch.float32)
    want = dd.decode_core(q, kn, v, lengths)
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(got[3]).any()


def test_partial_kernels_refuse_cpu_tensors():
    """The wrappers launch their kernel or raise: CPU tensors reach the plain
    versions only through ``ops`` (impl "auto" / "torch")."""
    from repro_torch.kernels import ops

    q, k = torch.zeros((1, 2, 16)), torch.zeros((1, 8, 2, 16))
    lengths = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        dd.decode_attention_partial(q, k, k, lengths)
    with pytest.raises(ValueError, match="CUDA"):
        dd.combine_splits(torch.zeros((1, 2, 2, 16)), torch.zeros((1, 2, 2, 2)), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention_partial(q, k, k, lengths, impl="cuda")
    acc, ml = ops.decode_attention_partial(q, k, k, lengths)
    assert acc.shape == (1, 2, 16) and ml.shape == (1, 2, 2)
