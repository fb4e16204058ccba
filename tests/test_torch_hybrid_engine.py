"""Port's engine serving the Zamba2 hybrid (zamba2-2.7b) against the
reference, on the CPU in fp32.

A full ``EngineCore`` run at ``smoke_config("zamba2-2.7b")`` with the
reference's weights (``bridge.params_from_numpy``): the dense layout (the
Mamba2 state per cycle and layer, the shared block's K/V rows per cycle),
monolithic dt-masked bucket prefill, an ONLINE arrival that preempts an
OFFLINE request.  Token streams, finish reasons, ``StepOutputs`` and the
engine counters must equal the reference's exactly (greedy, fp32).  Also:
the layouts and proposers the port refuses for the hybrid, as the
reference does, and the draft pairings it serves; the NaN fault point staying inert on its cache (the reference's
``"k" in layers`` rule), and the cache's bytes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serving import core as jserving
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SpecDecodeConfig, draft_config
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.resilience import FaultInjector, FaultSpec
from repro_torch.serving import core as tserving
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.spec.proposers import NgramProposer

JCFG = jconfigs.smoke_config("zamba2-2.7b")
CFG = configs.smoke_config("zamba2-2.7b")
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
PARAMS = params_from_numpy(NP_PARAMS, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
                      clock=clock, max_slots=2, max_seq=96)
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
    """Streams, every step's outputs and the counters equal the reference's;
    every admission prefills once per cycle through the attention core."""
    jsteps, jstreams, jcounters = _serve("jax")
    ops.reset_launch_counts()
    tsteps, tstreams, tcounters = _serve("torch")
    counts = ops.launch_counts()
    assert tstreams == jstreams
    assert tsteps == jsteps
    assert tcounters == jcounters
    assert all(reason == "length" for _, reason, _ in tstreams)
    assert any(p for _, _, p in tstreams)  # a preempted request resumed
    n_cyc = CFG.num_layers // CFG.shared_attn_every
    admissions = len(tstreams) + sum(p for _, _, p in tstreams)
    assert counts["flash_attention_fwd"] == {"cuda": 0, "torch": n_cyc * admissions}
    decode_steps = tcounters["engine/steps_executed"] - admissions
    assert counts["decode_attention"] == {"cuda": 0, "torch": n_cyc * decode_steps}


def test_engine_refuses_speculation_and_paged_layouts_on_the_hybrid():
    """What the reference refuses on the hybrid stays refused: host
    proposers (``register_proposer`` of an n-gram lookup asserts an
    attention family there), paged KV, chunked prefill, and a hybrid draft
    streaming an attention target's chunked prefill (the reference's chunk
    program asserts at the first wave; the port refuses at construction).
    The draft pairings it accepts serve here with the plain greedy engine's
    streams: the hybrid with its own ``draft_config`` draft or an attention
    draft, and an attention target with a hybrid draft on monolithic
    prefill; ``proposer="ngram"`` registers nothing on the hybrid."""
    kw = dict(compute_dtype=torch.float32, device="cpu", max_slots=2, max_seq=32)
    dcfg = draft_config(configs.smoke_config("qwen3-1.7b"))
    dparams = T.init_params(dcfg, torch.Generator().manual_seed(1))
    hcfg = draft_config(CFG)
    assert hcfg.family == "hybrid" and hcfg.num_layers % hcfg.shared_attn_every == 0
    hparams = T.init_params(hcfg, torch.Generator().manual_seed(2))
    qcfg = configs.smoke_config("qwen3-1.7b")
    qparams = T.init_params(qcfg, torch.Generator().manual_seed(3))
    qdraft = dataclasses.replace(hcfg, vocab_size=qcfg.vocab_size)
    qdparams = T.init_params(qdraft, torch.Generator().manual_seed(4))

    def stream(eng):
        r = eng.core.submit(np.arange(9), tserving.SamplingParams(max_new_tokens=7))
        while eng.core.has_unfinished:
            eng.core.step()
        return list(r.output_tokens), eng.spec_rounds

    plain_h = stream(TEngine(CFG, PARAMS, **kw))[0]
    for d, p in ((hcfg, hparams), (dcfg, dparams)):
        toks, rounds = stream(TEngine(CFG, PARAMS, draft_cfg=d, draft_params=p, **kw))
        assert toks == plain_h and rounds > 0
    plain_q = stream(TEngine(qcfg, qparams, prefill_chunk=0, **kw))[0]
    toks, rounds = stream(TEngine(qcfg, qparams, draft_cfg=qdraft, draft_params=qdparams,
                                  prefill_chunk=0, **kw))
    assert toks == plain_q and rounds > 0
    with pytest.raises(ValueError, match="attention draft"):
        TEngine(qcfg, qparams, draft_cfg=qdraft, draft_params=qdparams, **kw)
    ngram = TEngine(CFG, PARAMS, spec=SpecDecodeConfig(proposer="ngram"), **kw)
    assert ngram._proposers == {} and not ngram.host_spec_enabled
    eng = TEngine(CFG, PARAMS, **kw)  # "auto" on a plain engine registers nothing
    assert not eng.spec_enabled and not eng.host_spec_enabled
    with pytest.raises(ValueError, match="attention family"):
        eng.register_proposer(NgramProposer())
    with pytest.raises(ValueError, match="paged KV"):
        TEngine(CFG, PARAMS, kv_page_size=16, **kw)
    with pytest.raises(ValueError, match="chunked prefill"):
        TEngine(CFG, PARAMS, prefill_chunk=32, **kw)


def test_nan_fault_point_is_inert_on_the_hybrid_cache():
    """``engine/nan_logits`` armed at p = 1 is consulted before every fused
    dispatch but poisons nothing (the hybrid has no per-layer ``k`` pool, as
    in the reference), so the streams equal an unarmed engine's and no slot
    is quarantined."""
    kw = dict(compute_dtype=torch.float32, device="cpu", decode_impl="torch",
              max_slots=2, max_seq=64)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab_size, n) for n in (12, 30, 7)]
    streams = []
    for inj in (None, FaultInjector(0, [FaultSpec("engine/nan_logits")])):
        eng = TEngine(CFG, PARAMS, fault_injector=inj, **kw)
        reqs = [eng.core.submit(p, tserving.SamplingParams(max_new_tokens=6),
                                priority=tserving.Priority.ONLINE) for p in prompts]
        while eng.core.has_unfinished:
            eng.core.step()
        streams.append([list(r.output_tokens) for r in reqs])
        if inj is not None:
            m = eng.obs.metrics
            assert m.counter("fault/nan_quarantines").value == 0
            assert inj.fires["engine/nan_logits"] > 0
    assert streams[0] == streams[1]


def test_cache_bytes_count_the_state_and_the_shared_rows():
    eng = TEngine(CFG, PARAMS, compute_dtype=torch.float32, device="cpu", max_slots=3,
                  max_seq=40)
    n_cyc, every = CFG.num_layers // CFG.shared_attn_every, CFG.shared_attn_every
    state = (2 * (CFG.ssm_conv - 1) * (CFG.d_inner + 2 * CFG.ssm_state) // 2
             + CFG.ssm_num_heads * CFG.ssm_head_dim * CFG.ssm_state)
    rows = 2 * 40 * CFG.num_kv_heads * CFG.resolved_head_dim
    assert eng.kv_cache_bytes() == 4 * 3 * (n_cyc * every * state + n_cyc * rows)
