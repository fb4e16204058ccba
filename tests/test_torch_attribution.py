"""SLO attribution and the trace schema of the port against the reference:
``repro_torch.obs.attribute`` and ``validate_events`` / ``validate_jsonl``
are held to ``repro.obs``'s on the same events, and a collocated
virtual-clock ``SpecInFRuntime`` run of each package (the same weights,
fp32, the same backlog and online arrivals) gives per-request segments that
agree to 1e-9 and telescope to each request's latency."""
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import obs as jobs
from repro.configs.base import SpecInFConfig as JSpecInF
from repro.core import SpecInFRuntime as JRuntime
from repro.core.profiles import dp_profile as jdp_profile
from repro.models import transformer as JT
from repro.serving import core as jcore
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch import obs as tobs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import SpecInFConfig as TSpecInF
from repro_torch.core import SpecInFRuntime as TRuntime
from repro_torch.core.profiles import dp_profile as tdp_profile
from repro_torch.serving import core as tcore
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.engine import Request as TRequest

JCFG = jconfigs.smoke_config("qwen3-1.7b")
CFG = configs.smoke_config("qwen3-1.7b")
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
SEGMENTS = ("queueing", "prefill", "decode", "preempted", "arrival_time", "finish_time",
            "first_token_time", "preemptions", "finish_state", "priority")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lifecycles(tr):
    """Transition sequences the unit cases feed both tracers."""
    return {
        # monolithic admission: the first token splits the RUNNING interval
        "monolithic_first_token": [
            ("transition", 1, None, "waiting", 0.0, "online"),
            ("transition", 1, "waiting", "running", 1.0, None),
            ("instant", 1, 1.25),
            ("transition", 1, "running", "finished_stopped", 2.0, None)],
        "preempted": [
            ("transition", 2, None, "waiting", 0.0, "offline"),
            ("transition", 2, "waiting", "running", 1.0, None),
            ("transition", 2, "running", "preempted", 2.0, None),
            ("transition", 2, "preempted", "running", 3.0, None),
            ("transition", 2, "running", "finished_length", 4.0, None)],
        # chunked prefill, a quarantine re-queue, then the retry budget
        "quarantine_then_error": [
            ("transition", 3, None, "waiting", 0.5, "online"),
            ("transition", 3, "waiting", "prefilling", 0.75, None),
            ("transition", 3, "prefilling", "running", 1.0, None),
            ("instant", 3, 1.0),
            ("transition", 3, "running", "preempted", 1.5, None),
            ("transition", 3, "preempted", "running", 1.625, None),
            ("transition", 3, "running", "finished_error", 2.5, None)],
        # shed by the ladder while queued; several lifecycles at one instant
        "shed_and_ties": [
            ("transition", 4, None, "waiting", 0.0, "offline"),
            ("transition", 5, None, "waiting", 0.0, "online"),
            ("transition", 4, "waiting", "finished_expired", 0.25, None),
            ("transition", 5, "waiting", "running", 0.25, None),
            ("instant", 5, 0.25),
            ("transition", 5, "running", "finished_length", 0.25, None)],
    }


def _feed(tracer, ops):
    for op in ops:
        if op[0] == "transition":
            _, rid, frm, to, t, pri = op
            tracer.transition(rid, frm, to, t, priority=pri)
        else:
            tracer.instant("first_token", op[2], request_id=op[1])


def _as_tuples(att):
    return {rid: tuple(getattr(ra, s) for s in SEGMENTS) + (ra.total, ra.latency_s, ra.ttft_s)
            for rid, ra in att.items()}


@pytest.mark.parametrize("case", list(_lifecycles(None)))
def test_attribution_unit_cases_match_reference(case):
    ops = _lifecycles(None)[case]
    jt, tt = jobs.StepTracer(), tobs.StepTracer()
    _feed(jt, ops)
    _feed(tt, ops)
    got = _as_tuples(tobs.attribute(tt.events))
    assert got == _as_tuples(jobs.attribute(jt.events))
    assert _as_tuples(tt.attribution()) == got
    for ra in tobs.attribute(tt.events).values():
        assert abs(ra.total - ra.latency_s) <= 1e-9
    if case == "monolithic_first_token":
        assert got[1][:3] == (1.0, 0.25, 0.75)
    elif case == "quarantine_then_error":
        assert got[3][3] == 0.125 and got[3][8] == "finished_error"


def test_schema_validator_matches_reference(tmp_path):
    """The same tracer output validates clean under both; the same junk gets
    the same errors; a port trace file validates under both JSONL readers."""
    tt = tobs.StepTracer()
    tt.quantum(0.0, 0.1, k=2, revoked=True)
    tt.transition(1, None, "waiting", 0.0, priority="online")
    tt.transition(1, "waiting", "finished_error", 0.1, priority="online")
    tt.span("decode", "slot0", 0.0, 0.1, tokens=2)
    tt.span("recovery", "control", 0.1, 0.1, requests=1, tokens=3, clock_shift=-0.5)
    tt.instant("first_token", 0.1, request_id=1)
    tt.instant("arrival_restamp", 0.1, request_id=1, old=0.0, new=-0.5)
    assert tobs.validate_events(tt.events) == jobs.validate_events(tt.events) == []
    bad = [
        {"type": "nope", "seq": 0},
        {"type": "quantum", "t0": 0.0, "seq": 1, "args": {}},
        {"type": "transition", "request_id": 1, "frm": None, "to": "zombie", "t": 0.0,
         "seq": 2, "priority": None},
        {"type": "span", "name": "s", "track": "t", "t0": 1.0, "t1": 0.5, "seq": 3,
         "args": {}},
        {"type": "span", "name": "recovery", "track": "c", "t0": 0.0, "t1": 0.0, "seq": 4,
         "args": {"requests": 1}},
        {"type": "instant", "name": "arrival_restamp", "track": "c", "t": 0.0, "seq": 4,
         "args": {}},
    ]
    errs = tobs.validate_events(bad)
    assert errs == jobs.validate_events(bad) and len(errs) >= 6
    p = tmp_path / "trace.jsonl"
    tt.write_jsonl(str(p))
    assert tobs.validate_jsonl(str(p)) == jobs.validate_jsonl(str(p)) == (len(tt.events), [])
    lines = p.read_text().splitlines()
    p.write_text("\n".join([lines[0], lines[2], lines[1], *lines[3:]]) + "\n")
    assert tobs.validate_jsonl(str(p)) == jobs.validate_jsonl(str(p))


def _collocated(pkg):
    """A virtual-clock SpecInF run: 2 OFFLINE requests fill bubbles around
    6 ONLINE arrivals, 12 iterations of a no-op train step."""
    if pkg == "repro":
        eng = JEngine(JCFG, jax.tree.map(jnp.asarray, NP_PARAMS), max_slots=2, max_seq=96,
                      compute_dtype=jnp.float32)
        core, Req, Runtime, SpecInF, dp = jcore, JRequest, JRuntime, JSpecInF, jdp_profile
    else:
        eng = TEngine(CFG, params_from_numpy(NP_PARAMS, device="cpu"), max_slots=2,
                      max_seq=96, compute_dtype=torch.float32, device="cpu")
        core, Req, Runtime, SpecInF, dp = tcore, TRequest, TRuntime, TSpecInF, tdp_profile
    rid0 = None
    for _ in range(2):
        cr = eng.core.submit(np.arange(8), core.SamplingParams(max_new_tokens=32),
                             priority=core.Priority.OFFLINE, arrival_time=0.0)
        rid0 = cr.request_id if rid0 is None else rid0
    reqs = [Req(prompt=np.arange(4), max_new_tokens=3, arrival_time=0.03 * i, online=True)
            for i in range(6)]
    rt = Runtime(train_step=lambda s, b: (s, {"loss": 0.0}), train_state=None,
                 batch_iter=itertools.repeat({}),
                 profile=dp("tiny", compute_s=0.03, comm_s=0.04), engine=eng,
                 online_requests=reqs, cfg=SpecInF(), decode_microstep_s=0.002)
    metrics = rt.run(num_iterations=12)
    att = {rid - rid0: ra for rid, ra in eng.obs.tracer.attribution().items()}
    return eng, metrics, att


def test_collocated_attribution_matches_reference():
    _, _, jatt = _collocated("repro")
    eng, metrics, att = _collocated("repro_torch")
    assert set(att) == set(jatt) and len(att) == 8
    for rid, ra in att.items():
        ja = jatt[rid]
        for s in SEGMENTS:
            a, b = getattr(ra, s), getattr(ja, s)
            if isinstance(a, float):
                assert abs(a - b) <= 1e-9, (rid, s)
            else:
                assert a == b, (rid, s)
    finished = [ra for ra in att.values() if ra.finish_time is not None]
    assert len(finished) == 8
    for ra in finished:
        assert abs(ra.total - ra.latency_s) <= 1e-9
    online = sorted(ra.ttft_s for ra in finished if ra.priority == "online")
    assert len(online) == metrics.online_served == 6
    assert online == pytest.approx(sorted(metrics.online_ttft_s), abs=1e-12)
    tr = eng.obs.tracer
    assert tr.dropped == 0 and tobs.validate_events(tr.events) == []
    quanta = [ev for ev in tr.events if ev["type"] == "quantum"]
    assert quanta and all(ev["args"]["revoked"] is False for ev in quanta)
    assert json.loads(json.dumps(tr.events)) == tr.events
