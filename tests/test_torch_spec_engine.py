"""Port speculating engine against the reference, on the CPU in fp32.

The JAX ``InferenceEngine`` and the port's (``device="cpu"``) are built on
the same target and draft weights (the reference's init, bridged) and the
same virtual clock, with ``proposer`` "draft" (a draft pairing), "ngram"
(host-only trees, no draft model) or "auto" (both, routed per quantum), and
get the same submissions through ``EngineCore``: prompts longer than one
chunk, token-budgeted steps that keep slots PREFILLING across quanta (the
draft's chunk stream rides the same waves), a radix hit, and an ONLINE
arrival that preempts an OFFLINE request which later resumes.  Token
streams, finish reasons, every step's ``StepOutputs`` (``k``, ``gamma``,
``proposer``, ``spec_accepted``, ``spec_proposed`` included) and the
speculation counters must be identical, and the streams must equal the
plain greedy engine's.  A 3-iteration ``SpecInFRuntime`` run with the gamma
controller must give the reference's phase counts, spec rounds and token
streams."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import core as jcore
from repro.configs.base import SpecDecodeConfig as JSpecDecodeConfig
from repro.configs.base import SpecInFConfig as JSpecInFConfig
from repro.configs.base import draft_config as jdraft_config
from repro.core import profiles as jprofiles
from repro.models import transformer as JT
from repro.serving import core as jserving
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.spec.proposers import StaticSuffixProposer as JSuffix
from repro_torch import configs
from repro_torch import core as tcore
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SpecDecodeConfig, SpecInFConfig
from repro_torch.serving import core as tserving
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.spec.proposers import StaticSuffixProposer

JCFG = jconfigs.smoke_config("qwen3-1.7b")
CFG = configs.smoke_config("qwen3-1.7b")
JDCFG, DCFG = jdraft_config(JCFG), configs.draft_config(CFG)
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
NP_DPARAMS = jax.tree.map(np.array, JT.init_params(JDCFG, jax.random.PRNGKey(1)))
MAX_SLOTS, MAX_SEQ = 2, 96
PROPOSERS = ("draft", "ngram", "auto", "suffix")
COUNTERS = ("engine/spec_rounds", "engine/spec_drafted", "engine/spec_accepted",
            "spec/proposer/router_switches", "spec/proposer/no_match_fallbacks")


@pytest.fixture(autouse=True, scope="module")
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


def _engine(pkg, proposer, clock, **kw):
    """A speculating engine of either package (``proposer=None``: plain)."""
    if pkg == "jax":
        spec = {} if proposer is None else {"spec": JSpecDecodeConfig(proposer=proposer)}
        if proposer in ("draft", "auto"):
            spec.update(draft_cfg=JDCFG,
                        draft_params=jax.tree.map(jnp.asarray, NP_DPARAMS))
        return JEngine(JCFG, jax.tree.map(jnp.asarray, NP_PARAMS),
                       compute_dtype=jnp.float32, clock=clock, **spec, **kw)
    spec = {} if proposer is None else {"spec": SpecDecodeConfig(proposer=proposer)}
    if proposer in ("draft", "auto"):
        spec.update(draft_cfg=DCFG, draft_params=params_from_numpy(NP_DPARAMS, device="cpu"))
    return TEngine(CFG, params_from_numpy(NP_PARAMS, device="cpu"),
                   compute_dtype=torch.float32, clock=clock, device="cpu", **spec, **kw)


def _prompts():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, CFG.vocab_size, 32)  # two full 16-token pages
    a = np.concatenate([shared, rng.integers(0, CFG.vocab_size, 14)])  # 46
    b = rng.integers(0, CFG.vocab_size, 40)
    c = np.concatenate([shared, rng.integers(0, CFG.vocab_size, 5)])  # 37
    d = rng.integers(0, CFG.vocab_size, 20)
    return a, b, c, d


def _normalize(out, order):
    ids = lambda xs: [order[i] for i in xs]
    return {
        "admitted": ids(out.admitted),
        "preempted": ids(out.preempted),
        "finished": ids([cr.request_id for cr in out.finished]),
        "k": out.k, "gamma": out.gamma, "proposer": out.proposer,
        "spec_accepted": out.spec_accepted, "spec_proposed": out.spec_proposed,
        "prefill_tokens": out.prefill_tokens, "cost_steps": out.cost_steps,
        "outputs": sorted(
            (order[o.request_id], tuple(o.new_tokens), o.state.value,
             o.finish_reason, o.ttft_s)
            for o in out.outputs
        ),
    }


def _serve(pkg, proposer, corpus=None):
    """The scenario; returns the per-step outputs, the streams and the
    speculation counters.  "suffix" is the n-gram engine with a
    static-suffix proposer over ``corpus`` registered."""
    clock = Clock()
    eng = _engine(pkg, "ngram" if proposer == "suffix" else proposer, clock,
                  max_slots=MAX_SLOTS, max_seq=MAX_SEQ)
    if proposer == "suffix":
        eng.register_proposer((JSuffix if pkg == "jax" else StaticSuffixProposer)(corpus))
    mod = jserving if pkg == "jax" else tserving
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
    for n in range(80):
        if n == 3:
            reqs.append(submit(c, 6, on))  # radix hit + preemption
        if n == 5:
            reqs.append(submit(d, 5, off))
        grant = mod.Grant(token_budget=40 if n < 2 else float("inf"))
        steps.append(_normalize(core.step(grant), order))
        clock.t += 0.01
        if n >= 5 and not core.has_unfinished:
            break
    assert not core.has_unfinished
    streams = [(list(r.output_tokens), r.finish_reason, r.preemptions) for r in reqs]
    m = eng.obs.metrics
    counters = {name: m.counter(name).value for name in COUNTERS}
    for name in ("draft", "ngram", "suffix"):
        for what in ("rounds", "proposed", "accepted"):
            key = f"spec/proposer/{what}/{name}"
            counters[key] = m.counter(key).value
    counters["pages_in_use"] = eng.pool.pages_in_use
    counters["metered"] = eng.prefill_metered_tokens
    return steps, streams, counters


@pytest.fixture(scope="module")
def plain_streams():
    return [s for s, _, _ in _serve("torch", None)[1]]


@pytest.mark.parametrize("proposer", PROPOSERS)
def test_spec_engine_matches_reference_and_plain_greedy(proposer, plain_streams):
    # the suffix corpus: every prompt followed by its plain greedy stream
    corpus = [list(map(int, p)) + s for p, s in zip(_prompts(), plain_streams)]
    jsteps, jstreams, jcounters = _serve("jax", proposer, corpus)
    tsteps, tstreams, tcounters = _serve("torch", proposer, corpus)
    assert tstreams == jstreams
    assert len(tsteps) == len(jsteps)
    for n, (t, j) in enumerate(zip(tsteps, jsteps)):
        assert t == j, f"step {n}"
    assert tcounters == jcounters
    assert [s for s, _, _ in tstreams] == plain_streams
    assert all(reason == "length" for _, reason, _ in tstreams)
    if proposer != "suffix":  # (the suffix engine drains a and b before c)
        assert any(p for _, _, p in tstreams)  # a preempted request resumed
    assert tcounters["engine/spec_rounds"] > 0
    ran = {s["proposer"] for s in tsteps if s["gamma"] is not None}
    if proposer == "suffix":  # the corpus-backed proposer wins the routing
        assert "suffix" in ran and ran <= {"ngram", "suffix"}
    else:
        assert ran == ({"draft", "ngram"} if proposer == "auto" else {proposer})
    for name in {"auto": ("draft", "ngram"), "suffix": ("suffix",)}.get(
            proposer, (proposer,)):
        assert tcounters[f"spec/proposer/rounds/{name}"] > 0


# ---------------------------------------------------------------------------
# SpecInFRuntime with the gamma controller
# ---------------------------------------------------------------------------


def _runtime(pkg, microstep_s=0.004):
    rng = np.random.default_rng(3)
    offline = [rng.integers(0, CFG.vocab_size, n).astype(np.int32) for n in (8, 40)]
    online = [(rng.integers(0, CFG.vocab_size, n).astype(np.int32), 0.02 * i)
              for i, n in enumerate((5, 12, 33))]
    engine = _engine(pkg, "auto", None, max_slots=3, max_seq=64)
    if pkg == "jax":
        serving, core, Request, profiles, cfg = (
            jserving, jcore, JRequest, jprofiles, JSpecInFConfig())
    else:
        serving, core, Request, profiles, cfg = (
            tserving, tcore, TRequest, tcore, SpecInFConfig())
    for p in offline:
        engine.core.submit(p, serving.SamplingParams(max_new_tokens=20),
                           priority=serving.Priority.OFFLINE)
    reqs = [Request(prompt=p, max_new_tokens=4, arrival_time=t, online=True)
            for p, t in online]
    rt = core.SpecInFRuntime(
        train_step=lambda s, b: (s, {"loss": 1.0}), train_state=None,
        batch_iter=iter(int, 1),
        profile=profiles.dp_profile("tiny", compute_s=0.05, comm_s=0.04),
        engine=engine, online_requests=reqs, cfg=cfg, decode_microstep_s=microstep_s,
    )
    m = rt.run(3)
    return {
        "phases": dict(m.phase_counts),
        "spec_rounds": m.spec_rounds,
        "offline_microsteps": m.offline_microsteps,
        "offline_tokens": m.offline_tokens_generated,
        "online_served": m.online_served,
        "virtual_time_s": m.virtual_time_s,
        "acceptance": rt.gamma_ctrl.acceptance,
        "streams": [(cr.priority.value, list(cr.output_tokens), cr.state.value)
                    for _, cr in sorted(rt.core.requests.items())],
    }


def test_runtime_with_gamma_controller_matches_reference():
    j, t = _runtime("jax"), _runtime("torch")
    assert t["phases"] == j["phases"]
    assert t["spec_rounds"] == j["spec_rounds"] > 0
    for key in ("offline_microsteps", "offline_tokens", "online_served", "streams"):
        assert t[key] == j[key], key
    assert t["virtual_time_s"] == pytest.approx(j["virtual_time_s"], rel=1e-12)
    assert t["acceptance"] == pytest.approx(j["acceptance"], rel=1e-12)
    assert t["offline_tokens"] > 0 and t["online_served"] == 3


@pytest.mark.parametrize("microstep_s, served", [(0.0115, 3), (0.0118, 0)],
                         ids=["below", "above"])
def test_runtime_microstep_past_longest_bubble_matches_reference(microstep_s, served):
    """The profile's longest bubble (its tail) is 11.76 ms.  A microstep just
    below it fits two quanta there and every online request finishes; just
    above it, one, and in the reference no online request finishes in three
    iterations.  The port reproduces both sides."""
    j, t = _runtime("jax", microstep_s), _runtime("torch", microstep_s)
    assert t["phases"] == j["phases"]
    for key in ("spec_rounds", "offline_microsteps", "offline_tokens", "online_served",
                "streams"):
        assert t[key] == j[key], key
    assert t["online_served"] == served
