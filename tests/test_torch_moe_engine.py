"""Port serving stack on the Mixture-of-Experts family against the reference,
on the CPU in fp32.

The JAX ``InferenceEngine`` and the port's (``device="cpu"``) serve
moonshot-v1-16b-a3b's smoke config (4 experts, top 2) on the same weights
(the reference's init, bridged) and the same virtual clock, and get the
same submissions through ``EngineCore``: prompts longer than one chunk,
token-budgeted steps that keep slots PREFILLING across quanta, a radix hit,
and an ONLINE arrival that preempts an OFFLINE request which later
resumes.  The cases cover the paged and the dense KV layout, chunked and
monolithic prefill, plain decode, a draft pairing (a 1-layer MoE draft)
and the n-gram proposer, and a capacity factor under which prefill drops
expert choices.  Token streams, finish reasons, every step's
``StepOutputs`` and the speculation counters must be identical.

Unlike the dense family's, a speculating MoE engine's streams need not
equal the plain engine's: expert capacity is shared by the tokens of a
routing group (a prefill chunk's row, a verify chunk, a decode step's
batch), and the schedule decides which tokens meet in a group: how a wave's
token budget splits a prompt into chunks, where a preemption falls.  The
reference has the same property, and the port follows it case by case."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SpecDecodeConfig as JSpecDecodeConfig
from repro.configs.base import draft_config as jdraft_config
from repro.models import transformer as JT
from repro.serving import core as jserving
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SpecDecodeConfig
from repro_torch.models import transformer as T
from repro_torch.serving import core as tserving
from repro_torch.serving.engine import InferenceEngine as TEngine


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCH = "moonshot-v1-16b-a3b"
JCFG, CFG = jconfigs.smoke_config(ARCH), configs.smoke_config(ARCH)
JDCFG, DCFG = jdraft_config(JCFG), configs.draft_config(CFG)
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
NP_DPARAMS = jax.tree.map(np.array, JT.init_params(JDCFG, jax.random.PRNGKey(1)))
MAX_SLOTS, MAX_SEQ = 2, 96
COUNTERS = ("engine/spec_rounds", "engine/spec_drafted", "engine/spec_accepted",
            "engine/d2h_transfers", "engine/prefill_skipped_tokens")

#: name: (kv_page_size, prefill_chunk, proposer, moe_capacity_factor)
CASES = {
    "paged_chunked_plain": (None, None, None, 1.25),
    "paged_chunked_draft": (None, None, "draft", 1.25),
    "paged_chunked_ngram": (None, None, "ngram", 1.25),
    "paged_monolithic_plain": (None, 0, None, 1.25),
    "dense_chunked_plain": (0, None, None, 1.25),
    "dense_chunked_draft": (0, None, "draft", 1.25),
    "dense_monolithic_ngram": (0, 0, "ngram", 1.25),
    "paged_chunked_drops": (None, None, None, 0.25),
    "dense_monolithic_drops": (0, 0, None, 0.25),
}


class Clock:
    """Virtual clock advanced by the test between steps only."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engine(pkg, case, clock):
    page, chunk, proposer, cf = case
    kw = dict(max_slots=MAX_SLOTS, max_seq=MAX_SEQ, kv_page_size=page,
              prefill_chunk=chunk, clock=clock)
    if pkg == "jax":
        cfg = dataclasses.replace(JCFG, moe_capacity_factor=cf)
        if proposer is not None:
            kw["spec"] = JSpecDecodeConfig(proposer=proposer)
        if proposer == "draft":
            kw.update(draft_cfg=JDCFG, draft_params=jax.tree.map(jnp.asarray, NP_DPARAMS))
        return JEngine(cfg, jax.tree.map(jnp.asarray, NP_PARAMS),
                       compute_dtype=jnp.float32, **kw)
    cfg = dataclasses.replace(CFG, moe_capacity_factor=cf)
    if proposer is not None:
        kw["spec"] = SpecDecodeConfig(proposer=proposer)
    if proposer == "draft":
        kw.update(draft_cfg=DCFG, draft_params=params_from_numpy(NP_DPARAMS, device="cpu"))
    return TEngine(cfg, params_from_numpy(NP_PARAMS, device="cpu"),
                   compute_dtype=torch.float32, device="cpu", **kw)


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


def _serve(pkg, case):
    """The scenario on an engine of ``CASES``' form; returns the per-step
    outputs, the streams and some counters."""
    clock = Clock()
    eng = _engine(pkg, case, clock)
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
    reqs = [submit(a, 24, off), submit(b, 20, off)]
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
    return steps, streams, counters


@pytest.mark.parametrize("case", list(CASES))
def test_moe_engine_matches_reference(case):
    jsteps, jstreams, jcounters = _serve("jax", CASES[case])
    tsteps, tstreams, tcounters = _serve("torch", CASES[case])
    assert tstreams == jstreams
    assert len(tsteps) == len(jsteps)
    for n, (t, j) in enumerate(zip(tsteps, jsteps)):
        assert t == j, f"step {n}"
    assert tcounters == jcounters
    assert all(reason == "length" for _, reason, _ in tstreams)
    page, chunk, proposer, _ = CASES[case]
    if chunk is None:
        assert any(p for _, _, p in tstreams)  # a preempted request resumed
    if proposer is not None:
        assert tcounters["engine/spec_rounds"] > 0
    if page is None:
        assert tcounters["engine/prefill_skipped_tokens"] >= 32  # a radix hit


def test_capacity_drops_change_the_streams():
    """The low capacity factor drops expert choices in prefill (a forward
    over the same prompts reports them), and the streams differ from the
    default factor's."""
    cfg = dataclasses.replace(CFG, moe_capacity_factor=0.25)
    params = params_from_numpy(NP_PARAMS, device="cpu")
    a, b, _, _ = _prompts()
    _, metrics = T.forward(cfg, params, torch.tensor(np.stack([a[:40], b])),
                           compute_dtype=torch.float32)
    assert metrics["moe_dropped"].item() > 0
    streams = {case: [s for s, _, _ in _serve("torch", CASES[case])[1]]
               for case in ("paged_chunked_drops", "paged_chunked_plain")}
    assert streams["paged_chunked_drops"] != streams["paged_chunked_plain"]
