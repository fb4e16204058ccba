"""The serve steps' 8-bit KV cache (``cache_dtype=float8_e4m3fn``) against
the reference, on the CPU:

  * the write rule: ``layers.to_cache`` bit for bit against ``jnp.astype``
    for both fp8 types, from fp32 and from bf16, over a grid of values
    around e4m3fn's largest (447.9 .. 465, 1e4, the infinities), NaNs of
    both signs, subnormals, and 200k random values
  * ``make_prefill_step`` + ``DECODE_STEPS`` greedy ``make_serve_step``
    steps of the qwen3, moonshot and musicgen smokes (fp32 compute, fp8
    cache, the reference's weights through ``params_from_numpy``) against
    the reference's ``T.prefill`` + ``T.decode_step`` with the same cache
    dtype (jitted, unsharded): at one rank in this process and over 2 and 4
    gloo ranks (qwen3's 2 KV heads at model 4 split the cache's
    sequence), tokens equal, logits within ``RTOL`` of their max, and
    every cache code of the gathered cache the reference's but for codes
    next to it (a value both sides compute in fp32 a rounding apart, on
    either side of a midpoint), at most ``STRADDLE_SHARE`` of the entries
  * the recurrent families: with an fp8 ``cache_dtype`` both packages
    prefill (the conv state's codes the reference's) and both raise on
    decode (the reference: JAX's ``TypePromotionError``; the port: a
    ``TypeError`` before any kernel)
  * ``decode_core`` / ``decode_partial_core`` over 8-bit rows against the
    reference's XLA decode path (``impl="xla"``, K/V widened to q's dtype)

One spawn of 4 ranks, which then runs the 2-rank cases on two of them over
a second group (each rank one torch thread, a ``FileStore`` in
``tmp_path``).  The test process computes the reference's runs while the
ranks run; the ranks do not load JAX.
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

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import decode_attention as dd
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.runtime import step as step_mod

RTOL = 1e-4
#: cache codes allowed next to the reference's (see the module docstring)
STRADDLE_SHARE = 1e-3
SEQ, PROMPT, DECODE_STEPS, BATCH = 32, 12, 8, 4
SPAWN_TIMEOUT_S = 150
FP8 = torch.float8_e4m3fn
ARCHS = {"qwen3": "qwen3-1.7b", "moonshot": "moonshot-v1-16b-a3b",
         "musicgen": "musicgen-large"}
#: (case name, config, mesh shape) by world size
CASES = {
    4: [("qwen3_seq_1x4", "qwen3", (1, 4)), ("moonshot_2x2", "moonshot", (2, 2)),
        ("musicgen_1x4", "musicgen", (1, 4))],
    2: [("qwen3_1x2", "qwen3", (1, 2)), ("moonshot_1x2", "moonshot", (1, 2)),
        ("musicgen_2x1", "musicgen", (2, 1))],
}
DM = ("data", "model")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the write rule
# ---------------------------------------------------------------------------


def _grid() -> np.ndarray:
    edge = [447.9, 448.0, 460.0, 464.0, 464.5, 465.0, 1e4, np.inf, np.nan, 2.0**-6,
            2.0**-7, 2.0**-9, 2.0**-10, 2.0**-14, 2.0**-16, 2.0**-17, 2.0**-18, 1e-30, 0.0,
            57344.0, 61439.0, 61440.0, 65504.0]
    edge = np.array(edge + [-e for e in edge], np.float32)
    rng = np.random.default_rng(0)
    return np.concatenate([edge, (rng.standard_normal(200_000) * 100).astype(np.float32),
                           (rng.standard_normal(1000) * 1e-3).astype(np.float32)])


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2"])
def test_write_rule_matches_jax_cast(name):
    import jax.numpy as jnp
    import ml_dtypes

    vals = _grid()
    bf16_bits = vals.astype(ml_dtypes.bfloat16).view(np.uint16)
    sources = {  # the same bits on both sides (a cast to bf16 may set a NaN's sign)
        "fp32": (torch.from_numpy(vals), jnp.asarray(vals)),
        "bf16": (torch.from_numpy(bf16_bits.astype(np.int16)).view(torch.bfloat16),
                 jnp.asarray(bf16_bits.view(ml_dtypes.bfloat16))),
    }
    for src, (t, j) in sources.items():
        got = L.to_cache(t, getattr(torch, name)).view(torch.uint8).numpy()
        want = np.asarray(j.astype(getattr(jnp, name))).view(np.uint8)
        bad = np.nonzero(got != want)[0]
        assert bad.size == 0, (src, vals[bad[:5]], got[bad[:5]], want[bad[:5]])
    # the codes where a plain cast differs: e4m3fn past 464 is NaN, not 448
    over = L.to_cache(torch.tensor([464.0, 464.5, -1e4, float("inf")]), torch.float8_e4m3fn)
    assert over.view(torch.uint8).tolist() == [0x7E, 0x7F, 0xFF, 0x7F]


# ---------------------------------------------------------------------------
# the serve steps against the reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _weights(cname):
    """The reference's weights (numpy) and prompt (tokens, or musicgen's
    embedding rows) of a config."""
    import jax

    from repro.models import transformer as JT

    jcfg = jconfigs.smoke_config(ARCHS[cname])
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab_size,
                                               (BATCH, PROMPT)).astype(np.int32)
    return np_params, np_params["embed"][tokens] if jcfg.embed_inputs else tokens


@functools.lru_cache(maxsize=None)
def _reference(cname):
    """The reference's unsharded run with an fp8 cache: prefill logits,
    each decode step's logits and tokens, the final cache's K / V codes."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT

    jcfg = jconfigs.smoke_config(ARCHS[cname])
    np_params, inputs = _weights(cname)
    jparams = jax.tree.map(jnp.asarray, np_params)
    logits, cache = JT.prefill(jcfg, jparams, jnp.asarray(inputs), SEQ,
                               compute_dtype=jnp.float32, cache_dtype=jnp.float8_e4m3fn)
    decode = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, t, c, compute_dtype=jnp.float32))
    out = {"prefill_logits": np.asarray(logits), "logits": [], "tokens": []}
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(DECODE_STEPS):
        logits, cache = decode(jparams, tok, cache)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out["logits"].append(np.asarray(logits))
        out["tokens"].append(np.asarray(tok))
    out["codes"] = {n: np.asarray(cache["layers"][n]).view(np.uint8) for n in ("k", "v")}
    return out


def _serve_run(cname, params, inputs, shape):
    """The port's prefill + decode steps on this rank's blocks over the
    initialised group: gathered prefill logits, per step the tokens and
    the logits (``T.decode_step`` under the step's contexts, as
    ``tests/test_torch_serve_steps.py``), the gathered cache's codes."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.act_sharding import activation_sharding
    from repro_torch.runtime import sharding as S

    cfg = configs.smoke_config(ARCHS[cname])
    mesh = make_mesh(shape, DM, device="cpu")
    sshape = ShapeConfig(cname, SEQ, BATCH, "decode")
    kw = dict(compute_dtype=torch.float32, cache_dtype=FP8)
    pre = step_mod.make_prefill_step(cfg, mesh, sshape, **kw)
    dec = step_mod.make_serve_step(cfg, mesh, sshape, **kw)
    local = pre.shard_params(params)
    logits, cache = pre.step(local, pre.shard_inputs(inputs))
    out = {"prefill_logits": pre.gather_output(logits), "logits": [], "tokens": [],
           "dtype": cache["layers"]["k"].dtype}
    vocab = S.P(dec.input_specs[0] if len(dec.input_specs) else None,
                S.ShardingPlan(cfg, mesh).vocab())
    specs = S.activation_specs(cfg, mesh, batch_sharded=dec.batch_sharded)
    tok = S.shard_tensor(torch.argmax(out["prefill_logits"], -1).to(torch.int32),
                         dec.input_specs, mesh)
    for _ in range(DECODE_STEPS):
        index = cache["index"]
        if index.ndim == 1 and dec.batch_sharded:
            index = S.shard_tensor(index, dec.input_specs, mesh)
        probe = {"index": index, "layers": {k: v.clone() for k, v in cache["layers"].items()}}
        with torch.no_grad(), activation_sharding(
                mesh, specs, cache_seq=dec.cache_specs["layers"]["k"][2]):
            lg, _ = T.decode_step(cfg, local, tok, probe, compute_dtype=torch.float32)
        out["logits"].append(S.gather_tensor(lg, vocab, mesh))
        tok, cache = dec.step(local, tok, cache)
        out["tokens"].append(dec.gather_output(tok))
    full = dec.gather_cache(cache)
    out["codes"] = {n: full["layers"][n].view(torch.uint8) for n in ("k", "v")}
    out["reshard_equal"] = all(
        torch.equal(dec.shard_cache(full)["layers"][n].view(torch.uint8),
                    cache["layers"][n].view(torch.uint8)) for n in ("k", "v"))
    return out


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(got - want).max())
    assert err <= RTOL * float(np.abs(want).max()), (what, err)


def _adjacent(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Whether two fp8 codes are neighbours on the number line (the codes of
    one sign run in order of magnitude; +0 and -0 meet at zero)."""
    key = lambda c: np.where(c & 0x80, -(c.astype(np.int32) & 0x7F), c.astype(np.int32))
    return np.abs(key(a) - key(b)) <= 1


def _check_run(got, ref, what):
    _close(got["prefill_logits"], ref["prefill_logits"], (what, "prefill"))
    for i in range(DECODE_STEPS):
        np.testing.assert_array_equal(got["tokens"][i].numpy(), ref["tokens"][i],
                                      err_msg=f"{what} step {i}")
        _close(got["logits"][i], ref["logits"][i], (what, "decode", i))
    for n in ("k", "v"):
        a, b = got["codes"][n].numpy(), ref["codes"][n]
        diff = a != b
        assert _adjacent(a[diff], b[diff]).all(), (what, n, a[diff][:5], b[diff][:5])
        assert diff.sum() <= STRADDLE_SHARE * diff.size, (what, n, int(diff.sum()))


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("cname", list(ARCHS))
def test_fp8_serve_steps_match_reference_one_rank(one_rank_group, cname):
    np_params, inputs = _weights(cname)
    ref = _reference(cname)
    got = _serve_run(cname, params_from_numpy(np_params, device="cpu"),
                     torch.as_tensor(inputs), (1, 1))
    assert got["dtype"] == FP8
    _check_run(got, ref, cname)


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    data = {c: torch.load(os.path.join(tmp, f"{c}.pt")) for c in ARCHS}
    results = {}
    for w in (4, 2):
        if rank >= w:
            break
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store{w}", rank=rank,
                                world_size=w)
        try:
            for name, cname, shape in CASES[w]:
                results[name] = _serve_run(cname, data[cname]["params"],
                                           data[cname]["inputs"], shape)
        finally:
            dist.destroy_process_group()
    torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank's results of the 4- and 2-rank cases, and the
    reference's runs (computed here while the ranks run)."""
    tmp = tmp_path_factory.mktemp("fp8")
    for cname in ARCHS:
        np_params, inputs = _weights(cname)
        torch.save({"params": params_from_numpy(np_params, device="cpu"),
                    "inputs": torch.as_tensor(inputs)}, os.path.join(tmp, f"{cname}.pt"))
    ctx = mp.start_processes(_worker, args=(4, str(tmp)), nprocs=4, join=False,
                             start_method="spawn")
    refs = {cname: _reference(cname) for cname in ARCHS}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish within {SPAWN_TIMEOUT_S} s")
    return refs, [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(4)]


@pytest.mark.parametrize("world", [2, 4], ids=["2ranks", "4ranks"])
def test_fp8_serve_steps_match_reference_over_ranks(spawned, world):
    refs, ranks = spawned
    for name, cname, _ in CASES[world]:
        for r in range(world):
            got = ranks[r][name]
            assert got["dtype"] == FP8 and got["reshard_equal"], (name, r)
            _check_run(got, refs[cname], (name, r))


# ---------------------------------------------------------------------------
# the recurrent families: prefill, and decode refused as the reference does
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,state", [("falcon-mamba-7b", "conv"), ("zamba2-2.7b", "conv_x")])
def test_recurrent_fp8_state_prefills_and_refuses_decode(arch, state):
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT

    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jl, jc = JT.prefill(jcfg, jax.tree.map(jnp.asarray, np_params), jnp.asarray(tokens), 16,
                        compute_dtype=jnp.float32, cache_dtype=jnp.float8_e4m3fn)
    params = params_from_numpy(np_params, device="cpu")
    with torch.no_grad():
        pl, pc = T.prefill(cfg, params, torch.as_tensor(tokens), 16,
                           compute_dtype=torch.float32, cache_dtype=FP8)
    _close(pl, np.asarray(jl), arch)
    leaf = lambda c: c["layers"][state] if state in c["layers"] else c["layers"]["mamba"][state]
    got, want = leaf(pc).view(torch.uint8).numpy(), np.asarray(leaf(jc)).view(np.uint8)
    diff = got != want
    assert leaf(pc).dtype == FP8 and _adjacent(got[diff], want[diff]).all()
    assert diff.sum() <= STRADDLE_SHARE * diff.size
    with pytest.raises(ValueError, match="romot"):  # TypePromotionError
        JT.decode_step(jcfg, jax.tree.map(jnp.asarray, np_params),
                       jnp.asarray(tokens[:, -1]), jc, compute_dtype=jnp.float32)
    with pytest.raises(TypeError, match="8-bit"):
        T.decode_step(cfg, params, torch.as_tensor(tokens[:, -1]), pc,
                      compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# the plain versions over 8-bit rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fp8", ["float8_e4m3fn", "float8_e5m2"])
def test_decode_cores_over_fp8_rows_match_reference_xla(fp8):
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    rng = np.random.default_rng(11)
    b, s, h, kvh, hd = 5, 48, 8, 2, 32
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kv = [L.to_cache(torch.from_numpy(rng.standard_normal((b, s, kvh, hd)).astype(np.float32)),
                     getattr(torch, fp8)) for _ in range(2)]
    lengths = np.array([0, 1, 17, 40, s], np.int32)
    jkv = [jnp.asarray(t.view(torch.uint8).numpy()).view(getattr(jnp, fp8)) for t in kv]
    want = np.asarray(jops.decode_attention(jnp.asarray(q), *jkv, jnp.asarray(lengths),
                                            impl="xla"))
    got = dd.decode_core(torch.from_numpy(q), *kv, torch.from_numpy(lengths))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6 * float(np.abs(want).max())
    # the partial form over two blocks, merged, is the same attention
    blk = s // 2
    parts = [dd.decode_partial_core(torch.from_numpy(q), kv[0][:, r * blk:(r + 1) * blk],
                                    kv[1][:, r * blk:(r + 1) * blk],
                                    torch.from_numpy(lengths - r * blk).clamp(0, blk))
             for r in range(2)]
    merged = dd.combine_partials_core(torch.stack([p[0] for p in parts], 1),
                                      torch.stack([p[1] for p in parts], 1), torch.float32)
    assert float(np.abs(merged.numpy() - want).max()) <= 1e-6 * float(np.abs(want).max())


def test_fp8_rows_pass_the_wrapper_checks_and_refuse_cpu():
    """The kernel's wrapper takes 8-bit K / V under fp32 or bf16 q (rows of
    whole 16-byte chunks) and raises on anything else; CPU tensors reach
    only the plain version, through ``ops``."""
    from repro_torch.kernels import ops

    q = torch.zeros((1, 2, 32))
    k = torch.zeros((1, 8, 2, 32), dtype=FP8)
    lengths = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        dd.decode_attention(q, k, k, lengths)
    with pytest.raises(ValueError, match="multiple of 16"):
        dd.check_head_dim(40, FP8)
    dd.check_head_dim(512, FP8)
    assert ops.decode_attention(q, k, k, lengths).shape == (1, 2, 32)
