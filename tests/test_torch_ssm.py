"""Port's Mamba1 family (falcon-mamba-7b) against the reference, on the CPU
in fp32.

The plain selective-scan chunk (#10) against the reference's Pallas kernel
(interpret mode, as its own tests run it) and its naive oracle
``ssm_scan_chunk_ref``, chaining included; the whole-sequence scan (one
``ops.ssm_scan_chunk`` call, one a layer in a monolithic prefill) against
the reference's 64-step chunked scan and chained plain chunks; the causal
conv, ``init_params`` (names, shapes, dtypes, scales), ``prefill`` /
``prefill_into_slot`` with bucket padding (the state after a padded prompt
equals the unpadded one's), ``decode_step`` and ``decode_loop``; and a full
``EngineCore`` run (dense layout, monolithic dt-masked bucket prefill, an
ONLINE arrival that preempts an OFFLINE request) whose token streams,
finish reasons, ``StepOutputs`` and counters must equal the reference's
with its scan kernel (``prefill_impl="pallas"``).  Inputs come from numpy
seeds, weights from the reference's init through
``bridge.params_from_numpy``.  Tolerance atol 1e-5 on O(1) values (fp32,
sums and scans in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels.ref import ssm_scan_chunk_ref
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro.serving import core as jserving
from repro.serving.engine import InferenceEngine as JEngine
from repro.spec.proposers import NgramProposer as JNgramProposer
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SpecDecodeConfig, draft_config
from repro_torch.kernels import ops
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.serving import core as tserving
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.spec.proposers import NgramProposer

ATOL = 1e-5
JCFG = jconfigs.smoke_config("falcon-mamba-7b")
CFG = configs.smoke_config("falcon-mamba-7b")
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
PARAMS = params_from_numpy(NP_PARAMS, device="cpu")
MIXER0 = jax.tree.map(lambda a: a[0].copy(), NP_PARAMS["layers"]["mixer"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


def _scan_inputs(seed, b, q, di, ds):
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((b, q, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, q, di)) - 2)).astype(np.float32)
    B_ = rng.standard_normal((b, q, ds)).astype(np.float32)
    C_ = rng.standard_normal((b, q, ds)).astype(np.float32)
    A = -np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32), (di, ds)).copy()
    h0 = rng.standard_normal((b, di, ds)).astype(np.float32)
    return xi, dt, B_, C_, A, h0


# ---------------------------------------------------------------------------
# the scan chunk (#10)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 64, 32, 8), (1, 64, 64, 16)], ids=str)
def test_scan_chunk_plain_matches_reference_kernel_and_oracle(shape):
    b, q, di, ds = shape
    args = _scan_inputs(0, b, q, di, ds)
    y, h = ops.ssm_scan_chunk(*map(_t, args), impl="torch")
    for ref in (jops.ssm_scan_chunk(*map(_j, args)), ssm_scan_chunk_ref(*map(_j, args))):
        _close(y, ref[0])
        _close(h, ref[1])


def test_scan_chunk_chains_across_chunks():
    """h carried from one 64-step chunk into the next equals one 128-step
    scan (the reference oracle over the whole sequence)."""
    xi, dt, B_, C_, A, h0 = _scan_inputs(1, 2, 128, 32, 8)
    first = ops.ssm_scan_chunk(*map(_t, (xi[:, :64], dt[:, :64], B_[:, :64], C_[:, :64], A, h0)),
                               impl="torch")
    second = ops.ssm_scan_chunk(*map(_t, (xi[:, 64:], dt[:, 64:], B_[:, 64:], C_[:, 64:], A)),
                                first[1], impl="torch")
    y_ref, h_ref = ssm_scan_chunk_ref(*map(_j, (xi, dt, B_, C_, A, h0)))
    _close(torch.cat([first[0], second[0]], dim=1), y_ref)
    _close(second[1], h_ref)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_selective_scan_chunked_matches_reference(impl):
    """100 steps: one full chunk and a zero-padded tail."""
    xi, dt, B_, C_, A, h0 = _scan_inputs(2, 2, 100, 32, 8)
    y_j, h_j = JSSM.selective_scan_chunked(*map(_j, (xi, dt, B_, C_, A, h0)), impl=impl)
    y_t, h_t = SSM.selective_scan_chunked(*map(_t, (xi, dt, B_, C_, A, h0)), impl="torch")
    _close(y_t, y_j)
    _close(h_t, h_j)


def _chained_plain(xi, dt, B_, C_, A, h0, chunk=64):
    """The plain scan over ``chunk``-step pieces, h carried across (the
    reference's chunking)."""
    ys, h = [], _t(h0)
    for c in range(0, xi.shape[1], chunk):
        y, h = ops.ssm_scan_chunk(*map(_t, (xi[:, c: c + chunk], dt[:, c: c + chunk],
                                            B_[:, c: c + chunk], C_[:, c: c + chunk], A)),
                                  h, impl="torch")
        ys.append(y)
    return torch.cat(ys, dim=1), h


@pytest.mark.parametrize("pad", [False, True], ids=["dense", "dt0_pad"])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("s", [1, 8, 63, 64, 65, 100, 256])
def test_selective_scan_one_call_matches_reference_and_chained_chunks(s, b, pad):
    """The whole sequence in one ``ops.ssm_scan_chunk`` call equals the
    reference's 64-step chunked scan (Pallas kernel and XLA path) and the
    plain version chained over 64-step chunks.  With dt = 0 on the second
    half's steps (bucket padding), h equals the scan of the first half
    alone."""
    xi, dt, B_, C_, A, h0 = _scan_inputs(10 + s, b, s, 32, 8)
    valid = s // 2 if pad else s
    dt[:, valid:] = 0
    ops.reset_launch_counts()
    y_t, h_t = SSM.selective_scan_chunked(*map(_t, (xi, dt, B_, C_, A, h0)), impl="torch")
    assert ops.launch_counts()["ssm_scan"]["torch"] == 1
    assert tuple(y_t.shape) == (b, s, 32) and tuple(h_t.shape) == (b, 32, 8)
    for impl in ("pallas", "xla"):
        y_j, h_j = JSSM.selective_scan_chunked(*map(_j, (xi, dt, B_, C_, A, h0)), impl=impl)
        _close(y_t, y_j)
        _close(h_t, h_j)
    y_c, h_c = _chained_plain(xi, dt, B_, C_, A, h0)
    _close(y_t, y_c.numpy())
    _close(h_t, h_c.numpy())
    if pad and valid:
        y_v, h_v = ops.ssm_scan_chunk(*map(_t, (xi[:, :valid], dt[:, :valid], B_[:, :valid],
                                                C_[:, :valid], A, h0)), impl="torch")
        _close(h_t, h_v.numpy())
        _close(y_t[:, :valid], y_v.numpy())
    elif pad:  # every step is padding: h stays h0
        _close(h_t, h0)


@pytest.mark.parametrize("bucket", [32, 64, 256])
def test_monolithic_prefill_scans_once_per_layer(bucket):
    """A bucket-padded monolithic prefill makes one scan call a layer,
    whatever the bucket's length (no 64-step chunks), and leaves the state
    of the unpadded prompt."""
    n = bucket - 5
    prompt = np.random.default_rng(bucket).integers(0, CFG.vocab_size, n).astype(np.int32)
    buf = np.zeros((1, bucket), np.int32)
    buf[0, :n] = prompt
    tc = T.init_cache(CFG, 2, bucket, torch.float32, "cpu")
    ops.reset_launch_counts()
    _, tc = T.prefill_into_slot(CFG, PARAMS, _t(buf), n, 1, tc, max_seq=bucket, impl="torch",
                                compute_dtype=torch.float32)
    assert ops.launch_counts()["ssm_scan"] == {"cuda": 0, "torch": CFG.num_layers}
    _, unpadded = T.prefill(CFG, PARAMS, _t(prompt[None]), bucket, impl="torch",
                            compute_dtype=torch.float32)
    _close(tc["layers"]["h"][:, 1], unpadded["layers"]["h"][:, 0].numpy())
    _close(tc["layers"]["conv"][:, 1], unpadded["layers"]["conv"][:, 0].numpy())


# ---------------------------------------------------------------------------
# conv, block pieces, init
# ---------------------------------------------------------------------------


def test_causal_conv_and_step_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, CFG.d_inner)).astype(np.float32)
    w, bias = MIXER0["conv_w"], rng.standard_normal(CFG.d_inner).astype(np.float32)
    _close(SSM.causal_conv(_t(x), _t(w), _t(bias)), JSSM.causal_conv(_j(x), _j(w), _j(bias)))
    st = rng.standard_normal((2, CFG.ssm_conv - 1, CFG.d_inner)).astype(np.float32)
    out_t, st_t = SSM.causal_conv_step(_t(x[:, 0]), _t(st), _t(w), _t(bias))
    out_j, st_j = JSSM.causal_conv_step(_j(x[:, 0]), _j(st), _j(w), _j(bias))
    _close(out_t, out_j)
    _close(st_t, st_j)


def test_mamba1_step_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, CFG.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, CFG.ssm_conv - 1, CFG.d_inner)).astype(np.float32)
    h = rng.standard_normal((3, CFG.d_inner, CFG.ssm_state)).astype(np.float32)
    y_j, st_j = JSSM.mamba1_step(JCFG, jax.tree.map(_j, MIXER0), _j(x),
                                 {"conv": _j(conv), "h": _j(h)})
    y_t, st_t = SSM.mamba1_step(CFG, params_from_numpy(MIXER0, device="cpu"), _t(x),
                                {"conv": _t(conv), "h": _t(h)})
    _close(y_t, y_j)
    _close(st_t["conv"], st_j["conv"])
    _close(st_t["h"], st_j["h"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_init_params_names_shapes_dtypes_and_scales_match_reference(dtype):
    """The port's own init gives the reference's tree: every name, shape and
    dtype (``A_log`` and ``D`` stay fp32), std within 25% (other
    generators), constants equal to an ulp."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16
                     else np.asarray(a), JT.init_params(JCFG, jax.random.PRNGKey(0), jdtype)))[0]
    ref_dtypes = {tuple(p.key for p in path): a.dtype for path, a in
                  jax.tree_util.tree_flatten_with_path(
                      JT.init_params(JCFG, jax.random.PRNGKey(0), jdtype))[0]}
    port = T.init_params(CFG, torch.Generator().manual_seed(0), dtype=dtype)
    flat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v

    walk(port, ())
    assert set(flat) == set(ref_dtypes)
    for path, arr in ref:
        key = tuple(p.key for p in path)
        t = flat[key]
        assert tuple(t.shape) == arr.shape, key
        assert str(t.dtype).split(".")[-1] == str(ref_dtypes[key]), key
        tf = t.float()
        if arr.std() > 0 and key[-1] != "A_log":
            assert abs(tf.std().item() / arr.std() - 1) < 0.25, key
        else:  # constants (A_log: the log of 1..ds, to an ulp)
            torch.testing.assert_close(tf, torch.tensor(arr), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_prefill_into_slot_with_bucket_padding_matches_reference(impl):
    """A 13-token prompt padded to a 16 bucket into slot 1: the slot's conv
    and SSM state, its index and the first token equal the reference's, and
    the state equals that of the unpadded prompt (dt = 0 at pad steps)."""
    rng = np.random.default_rng(5)
    n, sb = 13, 16
    prompt = rng.integers(0, CFG.vocab_size, n).astype(np.int32)
    buf = np.zeros((1, sb), np.int32)
    buf[0, :n] = prompt
    jc = JT.init_cache(JCFG, 3, 32, jnp.float32)
    jc["index"] = jnp.zeros((3,), jnp.int32)
    tok_j, jc = JT.prefill_into_slot(JCFG, jax.tree.map(_j, NP_PARAMS), _j(buf), jnp.int32(n),
                                     jnp.int32(1), jc, max_seq=32, impl=impl,
                                     compute_dtype=jnp.float32)
    tc = T.init_cache(CFG, 3, 32, torch.float32, "cpu")
    tok_t, tc = T.prefill_into_slot(CFG, PARAMS, _t(buf), n, 1, tc, max_seq=32, impl="torch",
                                    compute_dtype=torch.float32)
    assert int(tok_t) == int(tok_j)
    for name in ("conv", "h"):
        _close(tc["layers"][name], jc["layers"][name])
    assert tc["index"].tolist() == [0, n, 0]
    _, unpadded = T.prefill(CFG, PARAMS, _t(prompt[None]), 32, impl="torch",
                            compute_dtype=torch.float32)
    _close(tc["layers"]["conv"][:, 1], unpadded["layers"]["conv"][:, 0].numpy())
    _close(tc["layers"]["h"][:, 1], unpadded["layers"]["h"][:, 0].numpy())


def test_decode_step_and_loop_match_reference():
    """A 3-slot cache with random states: one decode step, then a fused
    loop where slot 2 has no budget (frozen token and index; its state still
    advances, as the reference's)."""
    rng = np.random.default_rng(6)
    jc = JT.init_cache(JCFG, 3, 32, jnp.float32)
    conv = rng.standard_normal(jc["layers"]["conv"].shape).astype(np.float32)
    h = rng.standard_normal(jc["layers"]["h"].shape).astype(np.float32)
    idx = np.asarray([4, 9, 2], np.int32)
    toks = rng.integers(0, CFG.vocab_size, 3).astype(np.int32)
    jp = jax.tree.map(_j, NP_PARAMS)
    jc = {"index": _j(idx), "layers": {"conv": _j(conv), "h": _j(h)}}
    tc = {"index": _t(idx), "layers": {"conv": _t(conv.copy()), "h": _t(h.copy())}}
    lj, jc = JT.decode_step(JCFG, jp, _j(toks), jc, compute_dtype=jnp.float32)
    lt, tc = T.decode_step(CFG, PARAMS, _t(toks), tc, compute_dtype=torch.float32)
    _close(lt, lj, atol=1e-4)
    rem = np.asarray([5, 3, 0], np.int32)
    nxt = np.array(jnp.argmax(lj, -1).astype(jnp.int32))
    out_j = JT.decode_loop(JCFG, jp, _j(nxt), jc, _j(rem), k=4, max_seq=32,
                           compute_dtype=jnp.float32)
    out_t = T.decode_loop(CFG, PARAMS, _t(nxt), tc, _t(rem), k=4, max_seq=32,
                          compute_dtype=torch.float32)
    for a, b in zip((out_t[0], out_t[2], out_t[3], out_t[4]),
                    (out_j[0], out_j[2], out_j[3], out_j[4])):
        assert a.tolist() == np.asarray(b).tolist()
    assert out_t[1]["index"].tolist() == np.asarray(out_j[1]["index"]).tolist()
    _close(out_t[1]["layers"]["h"], out_j[1]["layers"]["h"], atol=1e-4)
    _close(out_t[1]["layers"]["conv"], out_j[1]["layers"]["conv"], atol=1e-4)


# ---------------------------------------------------------------------------
# EngineCore
# ---------------------------------------------------------------------------


class Clock:
    """Virtual clock advanced by the test between steps only."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


COUNTERS = ("engine/prefill_prompt_tokens", "engine/prefill_metered_tokens",
            "engine/generated_tokens", "engine/d2h_transfers", "engine/steps_executed",
            "core/preemptions")


def _serve(pkg):
    clock = Clock()
    if pkg == "jax":
        eng = JEngine(JCFG, jax.tree.map(jnp.asarray, NP_PARAMS), compute_dtype=jnp.float32,
                      clock=clock, prefill_impl="pallas", max_slots=2, max_seq=96)
        mod = jserving
    else:
        eng = TEngine(CFG, params_from_numpy(NP_PARAMS, device="cpu"),
                      compute_dtype=torch.float32, clock=clock, device="cpu",
                      decode_impl="torch", max_slots=2, max_seq=96)
        mod = tserving
        assert not eng.paged and eng.prefill_chunk == 0
    core = eng.core
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, n) for n in (46, 40, 20, 9)]
    order = {}

    def submit(prompt, n, priority):
        cr = core.submit(prompt, mod.SamplingParams(max_new_tokens=n), priority=priority,
                         arrival_time=clock.t)
        order[cr.request_id] = len(order)
        return cr

    off, on = mod.Priority.OFFLINE, mod.Priority.ONLINE
    reqs = [submit(prompts[0], 30, off), submit(prompts[1], 24, off)]
    steps = []
    for n in range(80):
        if n == 1:
            reqs.append(submit(prompts[2], 6, on))
        if n == 3:
            reqs.append(submit(prompts[3], 5, off))
        out = core.step(mod.Grant(token_budget=40 if n < 2 else float("inf")))
        steps.append((
            [order[i] for i in out.admitted], [order[i] for i in out.preempted],
            [order[cr.request_id] for cr in out.finished], out.k, out.prefill_tokens,
            out.cost_steps,
            sorted((order[o.request_id], tuple(o.new_tokens), o.state.value, o.finish_reason,
                    o.ttft_s) for o in out.outputs),
        ))
        clock.t += 0.01
        if n >= 3 and not core.has_unfinished:
            break
    assert not core.has_unfinished
    m = eng.obs.metrics
    return (steps, [(list(r.output_tokens), r.finish_reason, r.preemptions) for r in reqs],
            {name: m.counter(name).value for name in COUNTERS})


def test_engine_core_matches_reference():
    jsteps, jstreams, jcounters = _serve("jax")
    tsteps, tstreams, tcounters = _serve("torch")
    assert tstreams == jstreams
    assert tsteps == jsteps
    assert tcounters == jcounters
    assert all(reason == "length" for _, reason, _ in tstreams)
    assert any(p for _, _, p in tstreams)  # a preempted request resumed


def test_engine_refuses_speculation_on_the_recurrent_family():
    """What the reference refuses on Mamba1 stays refused: host proposers
    (``register_proposer`` of an n-gram lookup asserts an attention family
    there), paged KV and chunked prefill.  A draft pairing (an attention
    draft, or Mamba1's own ``draft_config``) is accepted and "auto"
    registers the draft alone; ``proposer="ngram"`` registers nothing, so
    the engine decodes plainly, as the reference's does."""
    kw = dict(compute_dtype=torch.float32, device="cpu", max_slots=2, max_seq=32)
    jkw = dict(compute_dtype=jnp.float32, max_slots=2, max_seq=32)
    jparams = jax.tree.map(jnp.asarray, NP_PARAMS)
    dcfg = draft_config(configs.smoke_config("qwen3-1.7b"))
    dparams = T.init_params(dcfg, torch.Generator().manual_seed(1))
    own = draft_config(CFG)
    for draft, params in ((dcfg, dparams), (own, T.init_params(own, torch.Generator()))):
        eng = TEngine(CFG, PARAMS, draft_cfg=draft, draft_params=params, **kw)
        assert eng.spec_enabled and not eng.host_spec_enabled
        assert list(eng._proposers) == ["draft"]
    ngram = TEngine(CFG, PARAMS, spec=SpecDecodeConfig(proposer="ngram"), **kw)
    jngram = JEngine(JCFG, jparams, spec=jconfigs.SpecDecodeConfig(proposer="ngram"), **jkw)
    assert ngram._proposers == jngram._proposers == {}
    assert ngram.proposer_router is None and not ngram.host_spec_enabled
    plain = TEngine(CFG, PARAMS, **kw)  # "auto" on a plain engine registers nothing
    assert not plain.spec_enabled and not plain.host_spec_enabled
    streams = []
    for eng in (ngram, plain):
        r = eng.core.submit(np.arange(7), tserving.SamplingParams(max_new_tokens=6))
        while eng.core.has_unfinished:
            assert eng.core.step().gamma is None  # no speculation
        streams.append(list(r.output_tokens))
    assert streams[0] == streams[1] and len(streams[0]) == 6
    with pytest.raises(ValueError, match="attention family"):
        plain.register_proposer(NgramProposer())
    with pytest.raises(AssertionError, match="attention family"):
        JEngine(JCFG, jparams, **jkw).register_proposer(JNgramProposer())
    with pytest.raises(ValueError):
        TEngine(CFG, PARAMS, kv_page_size=16, **kw)
    with pytest.raises(ValueError, match="chunked prefill"):
        TEngine(CFG, PARAMS, prefill_chunk=32, **kw)
