"""Port serving stack against the reference: the JAX ``InferenceEngine`` (fp32)
and the port's (``device="cpu"``, fp32) are built on the same weights and the
same virtual clock and get the same submissions through ``EngineCore``.  The
run holds prompts longer than one 32-token chunk, token-budgeted steps that
leave slots PREFILLING across quanta, two prompts sharing a page-aligned
prefix (radix hits), and an ONLINE arrival that preempts an OFFLINE request
which later resumes.  Token streams, finish reasons and every step's
``StepOutputs`` (deltas, admitted, preempted, finished, k, prefill tokens,
TTFT) must be identical; requests are matched by order of submission."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.obs.metrics import STABLE_NAMES
from repro.serving import core as jcore
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.serving import core as tcore
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.engine import Request as TRequest

JCFG = jconfigs.smoke_config("qwen3-1.7b")
CFG = configs.smoke_config("qwen3-1.7b")
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
MAX_SLOTS, MAX_SEQ = 2, 96


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Clock:
    """Virtual clock advanced by the test between steps only, so both
    engines read the same instants however often they call it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engines():
    jclock, tclock = Clock(), Clock()
    jeng = JEngine(
        JCFG, jax.tree.map(jnp.asarray, NP_PARAMS), max_slots=MAX_SLOTS,
        max_seq=MAX_SEQ, compute_dtype=jnp.float32, clock=jclock,
    )
    teng = TEngine(
        CFG, params_from_numpy(NP_PARAMS, device="cpu"), max_slots=MAX_SLOTS,
        max_seq=MAX_SEQ, compute_dtype=torch.float32, clock=tclock,
        device="cpu",
    )
    return (jeng, jclock, jcore), (teng, tclock, tcore)


def _prompts():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, CFG.vocab_size, 32)  # two full 16-token pages
    a = np.concatenate([shared, rng.integers(0, CFG.vocab_size, 14)])  # 46
    b = rng.integers(0, CFG.vocab_size, 40)
    c = np.concatenate([shared, rng.integers(0, CFG.vocab_size, 5)])  # 37
    d = rng.integers(0, CFG.vocab_size, 20)
    return a, b, c, d


def _normalize(out, order):
    """A step's outputs with request ids replaced by submission order."""
    ids = lambda xs: [order[i] for i in xs]
    return {
        "admitted": ids(out.admitted),
        "preempted": ids(out.preempted),
        "finished": ids([cr.request_id for cr in out.finished]),
        "k": out.k,
        "prefill_tokens": out.prefill_tokens,
        "cost_steps": out.cost_steps,
        "outputs": sorted(
            (order[o.request_id], tuple(o.new_tokens), o.state.value,
             o.finish_reason, o.ttft_s)
            for o in out.outputs
        ),
    }


def _run(eng, clock, mod):
    """The scenario, identical for both packages; returns the per-step
    normalized outputs, the final streams and some engine counters."""
    core = eng.core
    a, b, c, d = _prompts()
    order = {}

    def submit(prompt, n, priority):
        cr = core.submit(prompt, mod.SamplingParams(max_new_tokens=n),
                         priority=priority, arrival_time=clock.t)
        order[cr.request_id] = len(order)
        return cr

    off, on = mod.Priority.OFFLINE, mod.Priority.ONLINE
    reqs = [submit(a, 30, off), submit(b, 24, off)]
    steps = []
    for n in range(60):
        if n == 3:
            # radix hit on a's two cached prefix pages; both slots hold
            # RUNNING OFFLINE requests -> preemption
            reqs.append(submit(c, 6, on))
        if n == 5:
            reqs.append(submit(d, 5, off))
        # early steps are token-budgeted so prompts stream across quanta
        grant = mod.Grant(token_budget=40 if n < 2 else float("inf"))
        steps.append(_normalize(core.step(grant), order))
        clock.t += 0.01
        if not core.has_unfinished:
            break
    assert not core.has_unfinished
    probe_cls = JRequest if mod is jcore else TRequest
    probe = probe_cls(prompt=np.concatenate([a[:32], d]), max_new_tokens=8)
    streams = [(list(r.output_tokens), r.finish_reason, r.preemptions) for r in reqs]
    counters = {
        "skipped": eng.prefill_skipped_tokens,
        "prompt": eng.prefill_prompt_tokens,
        "metered": eng.prefill_metered_tokens,
        "generated": eng.generated_tokens_total,
        "d2h": eng.d2h_transfers,
        "preemptions": core.preemption_count,
        "can_admit": eng.can_admit(probe),
        "pages_in_use": eng.pool.pages_in_use,
    }
    return steps, streams, counters


@pytest.fixture(scope="module")
def runs():
    (jeng, jclock, jmod), (teng, tclock, tmod) = _engines()
    return _run(jeng, jclock, jmod), _run(teng, tclock, tmod)


def test_streams_and_finish_reasons_identical(runs):
    (_, jstreams, _), (_, tstreams, _) = runs
    assert tstreams == jstreams
    assert all(reason == "length" for _, reason, _ in tstreams)


def test_step_outputs_identical(runs):
    (jsteps, _, _), (tsteps, _, _) = runs
    assert len(tsteps) == len(jsteps)
    for n, (t, j) in enumerate(zip(tsteps, jsteps)):
        assert t == j, f"step {n}"


def test_scenario_exercises_prefix_hits_preemption_and_chunking(runs):
    (jsteps, jstreams, jcounters), (tsteps, _, tcounters) = runs
    assert tcounters == jcounters
    assert tcounters["skipped"] >= 32  # radix hits served prefix pages
    assert tcounters["preemptions"] >= 1
    assert any(s["preempted"] for s in tsteps)
    assert sum(s["prefill_tokens"] > 0 for s in tsteps) >= 3  # chunked waves
    assert any(p for _, _, p in jstreams)  # a preempted request resumed


def test_stream_abort_and_metric_names_match_reference():
    """``stream`` yields the reference's tokens, ``abort`` of a request in a
    slot finishes it and frees its slot and pages as the reference does, and
    every instrument the port registers carries one of the reference's
    stable names (what ``summarize`` reads)."""
    out = {}
    for eng, _, mod in _engines():
        core = eng.core
        a, b, _, _ = _prompts()
        r1 = core.submit(a, mod.SamplingParams(max_new_tokens=7), arrival_time=0.0)
        r2 = core.submit(b, mod.SamplingParams(max_new_tokens=20), arrival_time=0.0)
        toks = list(core.stream(r1))
        core.abort(r2)
        out[mod.__name__.split(".")[0]] = (
            toks, r2.state.value, r2.finish_reason, len(r2.output_tokens),
            eng.num_active, eng.pool.pages_in_use, eng.pool.reserved,
        )
        names = set(eng.obs.metrics.snapshot())
    assert out["repro_torch"] == out["repro"]
    assert out["repro_torch"][1] == "finished_aborted"
    assert out["repro_torch"][4] == 0  # the aborted slot was released
    assert names <= set(STABLE_NAMES), names - set(STABLE_NAMES)


def test_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(CFG, params_from_numpy(NP_PARAMS, device="cpu"))


def test_decode_graphs_only_on_cuda_and_replays_count_launches():
    """The CPU never captures a graph (the serving programs need the
    kernels on a card): an engine that ran the chunk waves, the decode loop
    and a monolithic admission holds none, while it still counts its
    prefill programs.  A replay's launches, and its bodies, land in the
    counters through ``ops.add_launch_counts``."""
    from repro_torch.kernels import ops

    engine = TEngine(CFG, params_from_numpy(NP_PARAMS, device="cpu"), max_slots=2,
                     max_seq=64, device="cpu")
    assert engine.paged and not engine.graphs
    mono = TEngine(CFG, params_from_numpy(NP_PARAMS, device="cpu"), max_slots=2,
                   max_seq=64, device="cpu", kv_page_size=0, prefill_chunk=0)
    for eng in (engine, mono):
        r = eng.core.submit(np.arange(1, 20), tcore.SamplingParams(max_new_tokens=3))
        while eng.core.has_unfinished:
            eng.core.step()
        assert len(r.output_tokens) == 3
        assert eng._graphs == {} and eng._decode_graphs == {} and eng.graph_pool_bytes() == 0
        assert eng.prefill_graph_count == 0
    assert engine.prefill_compile_counts() == {"target/chunk": 1}
    assert mono.prefill_compile_counts() == {"target/bucket": 1}
    ops.reset_launch_counts()
    ops.add_launch_counts({"paged_decode_attention": 3, "flash_attention_fwd": 0},
                          {"paged_prefill_attention": {"tc": 2}})
    counts = ops.launch_counts()
    assert counts["paged_decode_attention"] == {"cuda": 3, "torch": 0}
    assert counts["flash_attention_fwd"] == {"cuda": 0, "torch": 0}
    assert ops.body_counts()["paged_prefill_attention"] == {"tc": 2, "fma": 0}
    ops.reset_launch_counts()
