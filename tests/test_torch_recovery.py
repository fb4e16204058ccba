"""Crash-safe serving of the port against the reference: the write-ahead
journal, replay recovery, group commit, restamped deadlines, fault-counter
decay, the checkpointer and the warm-state snapshot.  Both packages run the
same submissions on the same weights (``params_from_numpy``, fp32) and the
same virtual clock; the crash model is ``RequestJournal.crash()`` (the file
cut back to its last fsync).  Journal records, recovery reports, final
streams and counters must equal the reference's; request ids are compared
relative to the first submission."""
import itertools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import resilience as jres
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.base import SpecInFConfig as JSpecInF
from repro.core import SpecInFRuntime as JRuntime
from repro.core.profiles import dp_profile as jdp_profile
from repro.models import transformer as JT
from repro.serving import core as jcore
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import configs
from repro_torch import resilience as tres
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import SpecInFConfig as TSpecInF
from repro_torch.core import SpecInFRuntime as TRuntime
from repro_torch.core.profiles import dp_profile as tdp_profile
from repro_torch.obs.schema import validate_events
from repro_torch.serving import core as tcore
from repro_torch.serving.engine import InferenceEngine as TEngine

JCFG = jconfigs.smoke_config("qwen3-1.7b")
CFG = configs.smoke_config("qwen3-1.7b")
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
STEP_S = 0.002

J = types.SimpleNamespace(
    name="repro", core=jcore, res=jres, Ckpt=JCheckpointer, Runtime=JRuntime,
    SpecInF=JSpecInF, dp_profile=jdp_profile,
    engine=lambda vnow, **kw: JEngine(
        JCFG, jax.tree.map(jnp.asarray, NP_PARAMS), clock=lambda: vnow[0],
        **{"compute_dtype": jnp.float32, **kw}),
)
T = types.SimpleNamespace(
    name="repro_torch", core=tcore, res=tres, Ckpt=Checkpointer, Runtime=TRuntime,
    SpecInF=TSpecInF, dp_profile=tdp_profile,
    engine=lambda vnow, **kw: TEngine(
        CFG, params_from_numpy(NP_PARAMS, device="cpu"), clock=lambda: vnow[0],
        device="cpu", **{"compute_dtype": torch.float32, **kw}),
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _engine(ns, vnow, paged=True, start=0.0, **kw):
    vnow[0] = start
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq", 128)
    kw.setdefault("kv_page_size", None if paged else 0)
    return ns.engine(vnow, **kw)


def _step(ns, core, vnow, token_budget=16):
    base = vnow[0]
    out = core.step(ns.core.Grant(
        now=base, token_budget=token_budget,
        advance_clock=lambda steps, b=base: vnow.__setitem__(0, b + steps * STEP_S),
    ))
    if out.cost_steps == 0 and not out.admitted:
        vnow[0] += STEP_S
    return out


def _drain(ns, core, vnow, limit=800, token_budget=16):
    n = 0
    while core.has_unfinished:
        _step(ns, core, vnow, token_budget)
        n += 1
        assert n < limit, "core.step() made no progress"


def _submit(ns, core, n_offline=2, n_online=3):
    rng = np.random.default_rng(0)
    reqs = [core.submit(rng.integers(0, CFG.vocab_size, 8),
                        ns.core.SamplingParams(max_new_tokens=12),
                        priority=ns.core.Priority.OFFLINE, arrival_time=0.0)
            for _ in range(n_offline)]
    for t in np.cumsum(rng.exponential(0.01, n_online)):
        reqs.append(core.submit(rng.integers(0, CFG.vocab_size, 8),
                                ns.core.SamplingParams(max_new_tokens=4, deadline_s=5.0),
                                priority=ns.core.Priority.ONLINE, arrival_time=float(t)))
    return reqs


def _records(ns, path, rid0):
    """The durable journal's records with request ids made relative."""
    records, torn = ns.res.read_journal(path)
    for rec in records:
        if "rid" in rec:
            rec["rid"] -= rid0
    return records, torn


def _streams(records):
    toks, fins = {}, {}
    for rec in records:
        if rec["k"] == "delta":
            cur = toks.setdefault(rec["rid"], [])
            if rec["tot"] == len(cur) + len(rec["tok"]):
                cur.extend(rec["tok"])
        elif rec["k"] == "fin":
            fins.setdefault(rec["rid"], []).append(rec)
    return toks, fins


def _report(r) -> tuple:
    return (r.replayed_records, r.replayed_tokens, r.requeued_waiting, r.resumed_inflight,
            r.skipped_finished, r.skipped_present, r.skipped_unfit, r.torn_tail,
            r.clock_shift)


def _both(run, tmp_path, *args):
    ref = run(J, str(tmp_path / "repro"), *args)
    port = run(T, str(tmp_path / "repro_torch"), *args)
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# Crash -> replay -> drain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_crash_recover_byte_identical(tmp_path, paged):
    """Kill mid-run, replay into a fresh engine, drain: every request has
    exactly one durable finish and its journaled stream equals the
    uninterrupted run's; the journal records equal the reference's."""

    def run(ns, d):
        os.makedirs(d)
        vnow = [0.0]
        ref_core = _engine(ns, vnow, paged).core
        ref = _submit(ns, ref_core)
        _drain(ns, ref_core, vnow)
        path = os.path.join(d, "j.jsonl")
        vnow = [0.0]
        core = _engine(ns, vnow, paged).core
        journal = ns.res.RequestJournal(path, fsync_interval=4)
        journal.attach(core)
        rid0 = _submit(ns, core)[0].request_id
        for _ in range(5):
            _step(ns, core, vnow)
        assert core.has_unfinished
        journal.crash()
        vnow2 = [0.0]
        core2 = _engine(ns, vnow2, paged).core
        journal2 = ns.res.RequestJournal(path, fsync_interval=4)
        report = journal2.recover_into(core2)
        journal2.attach(core2)
        _drain(ns, core2, vnow2)
        journal2.close()
        records, _ = _records(ns, path, rid0)
        return ([(r.finish_reason, list(r.output_tokens)) for r in ref], records,
                _report(report), journal2.appends, journal2.fsyncs)

    ref, records, report, _, _ = _both(run, tmp_path)
    toks, fins = _streams(records)
    assert report[2] + report[3] + report[4] == len(ref)
    for i, (reason, tokens) in enumerate(ref):
        assert len(fins[i]) == 1 and fins[i][0]["rsn"] == reason
        assert toks.get(i, []) == tokens


def test_kill_during_prefilling(tmp_path):
    def run(ns, d):
        prompt = np.arange(96) % CFG.vocab_size
        sp = ns.core.SamplingParams(max_new_tokens=6)
        vnow = [0.0]
        ref_core = _engine(ns, vnow).core
        ref = ref_core.submit(prompt, sp, arrival_time=0.0)
        _drain(ns, ref_core, vnow)
        os.makedirs(d)
        path = os.path.join(d, "j.jsonl")
        vnow = [0.0]
        core = _engine(ns, vnow).core
        journal = ns.res.RequestJournal(path, fsync_interval=1)
        journal.attach(core)
        r = core.submit(prompt, sp, arrival_time=0.0)
        _step(ns, core, vnow)  # a 96-token prompt against a 16-token grant
        state = r.state.value
        journal.crash()
        vnow2 = [0.0]
        core2 = _engine(ns, vnow2).core
        journal2 = ns.res.RequestJournal(path, fsync_interval=1)
        report = journal2.recover_into(core2)
        journal2.attach(core2)
        cr = core2.requests[r.request_id]
        resumed = cr.state.value
        _drain(ns, core2, vnow2)
        return (state, resumed, _report(report), list(ref.output_tokens),
                list(cr.output_tokens), cr.finish_reason)

    state, resumed, report, ref, got, reason = _both(run, tmp_path)
    assert (state, resumed, report[3]) == ("prefilling", "preempted", 1)
    assert got == ref and reason == "length"


def test_retry_at_survives_restore(tmp_path):
    """A quarantined request's fault count and backoff carry across the
    crash, shifted onto the restored clock."""

    def run(ns, d):
        os.makedirs(d)
        path = os.path.join(d, "j.jsonl")
        inj = ns.res.FaultInjector(seed=3, specs=(
            ns.res.FaultSpec("engine/nan_logits", probability=1.0, max_fires=1),))
        vnow = [0.0]
        core = _engine(ns, vnow, fault_injector=inj).core
        core.fault_backoff_s = 50.0
        journal = ns.res.RequestJournal(path, fsync_interval=1)
        journal.attach(core)
        r = core.submit(np.arange(6), ns.core.SamplingParams(max_new_tokens=8),
                        arrival_time=0.0)
        for _ in range(6):
            _step(ns, core, vnow)
        gap = r.retry_at - vnow[0]
        journal.crash()
        vnow2 = [100.0]
        core2 = _engine(ns, vnow2, start=100.0).core
        journal2 = ns.res.RequestJournal(path, fsync_interval=1)
        report = journal2.recover_into(core2)
        cr = core2.requests[r.request_id]
        return inj.total_fires, r.faults, gap, _report(report), cr.faults, cr.retry_at

    fires, faults, gap, report, faults2, retry_at = _both(run, tmp_path)
    assert (fires, faults, faults2, report[3]) == (1, 1, 1, 1)
    assert retry_at - 100.0 >= gap - 1e-9 and retry_at > 100.0


@pytest.mark.parametrize("interval", [4, 8])
def test_group_commit_loss_window(tmp_path, interval):
    """A crash loses at most ``fsync_interval`` records, and the automatic
    group commit keeps the pending count under it."""

    def run(ns, d):
        os.makedirs(d)
        path = os.path.join(d, "j.jsonl")
        journal = ns.res.RequestJournal(path, fsync_interval=interval)
        pending = []
        for i in range(2 * interval + 3):
            journal._append({"k": "tr", "rid": i, "t": 0.0, "st": "waiting", "f": 0,
                             "ra": 0.0})
            pending.append(journal.pending_records)
        before = len(ns.res.read_journal(path)[0])
        journal.crash()
        records, torn = ns.res.read_journal(path)
        return pending, before, len(records), torn, journal.fsyncs, journal.appends

    pending, _, durable, torn, fsyncs, appends = _both(run, tmp_path)
    assert max(pending) < interval and torn == 0
    assert appends - durable == pending[-1] <= interval  # appends count the meta record


def test_double_restore_idempotent(tmp_path):
    def run(ns, d):
        os.makedirs(d)
        path = os.path.join(d, "j.jsonl")
        vnow = [0.0]
        core = _engine(ns, vnow).core
        journal = ns.res.RequestJournal(path, fsync_interval=1)
        journal.attach(core)
        _submit(ns, core)
        for _ in range(4):
            _step(ns, core, vnow)
        journal.crash()
        vnow2 = [0.0]
        core2 = _engine(ns, vnow2).core
        journal2 = ns.res.RequestJournal(path, fsync_interval=1)
        first = journal2.recover_into(core2)
        again = journal2.recover_into(core2)
        return _report(first), _report(again), sum(len(q) for q in core2.waiting.values())

    first, again, depth = _both(run, tmp_path)
    restored = first[2] + first[3]
    assert restored > 0 and again[2] + again[3] == 0
    assert again[5] == restored and depth == restored


def test_deadline_ages_not_reset(tmp_path):
    """After a restart far in the future each request keeps its consumed
    deadline age: nothing mass-expires and nothing resets."""

    def run(ns, d):
        os.makedirs(d)
        path = os.path.join(d, "j.jsonl")
        vnow = [0.0]
        core = _engine(ns, vnow).core
        journal = ns.res.RequestJournal(path, fsync_interval=1)
        journal.attach(core)
        reqs = _submit(ns, core)
        for _ in range(3):
            _step(ns, core, vnow)
        aged = vnow[0]
        journal.crash()
        vnow2 = [1000.0]
        core2 = _engine(ns, vnow2, start=1000.0).core
        journal2 = ns.res.RequestJournal(path, fsync_interval=1)
        report = journal2.recover_into(core2)
        journal2.attach(core2)
        ages = []
        for rid, cr in core2.requests.items():
            old = next(r for r in reqs if r.request_id == rid)
            ages.append((aged - old.arrival_time, vnow2[0] - cr.arrival_time))
        _drain(ns, core2, vnow2)
        return (_report(report), ages,
                core2.obs.metrics.counter("core/finish_reason/expired").value)

    report, ages, expired = _both(run, tmp_path)
    assert report[2] + report[3] > 0 and expired == 0
    assert all(abs(a - b) <= 1e-9 for a, b in ages)


def test_recovery_trace_schema_and_attribution(tmp_path):
    """The recovery span and arrival_restamp instants validate against the
    schema, and attribution after replay telescopes and equals the
    reference's."""

    def run(ns, d):
        os.makedirs(d)
        path = os.path.join(d, "j.jsonl")
        vnow = [0.0]
        core = _engine(ns, vnow).core
        journal = ns.res.RequestJournal(path, fsync_interval=1)
        journal.attach(core)
        rid0 = _submit(ns, core)[0].request_id
        for _ in range(4):
            _step(ns, core, vnow)
        journal.crash()
        vnow2 = [0.0]
        core2 = _engine(ns, vnow2).core
        journal2 = ns.res.RequestJournal(path, fsync_interval=1)
        report = journal2.recover_into(core2)
        journal2.attach(core2)
        _drain(ns, core2, vnow2)
        tr = core2.obs.tracer
        spans = [ev["args"]["requests"] for ev in tr.events
                 if ev["type"] == "span" and ev["name"] == "recovery"]
        restamps = sum(ev["type"] == "instant" and ev["name"] == "arrival_restamp"
                       for ev in tr.events)
        att = {rid - rid0: (a.queueing, a.prefill, a.decode, a.preempted, a.arrival_time,
                            a.finish_time) for rid, a in tr.attribution().items()}
        return _report(report), spans, restamps, att, len(validate_events(tr.events))

    report, spans, restamps, att, errors = _both(run, tmp_path)
    assert spans == [report[2] + report[3]] and restamps == spans[0] and errors == 0
    for q, p, dec, pre, arr, fin in att.values():
        if fin is not None:
            assert abs(q + p + dec + pre - (fin - arr)) < 1e-6


def test_runtime_rearms_bubble_filling_from_journal(tmp_path):
    def run(ns, d):
        os.makedirs(d)
        path = os.path.join(d, "j.jsonl")
        vnow = [0.0]
        core = _engine(ns, vnow).core
        journal = ns.res.RequestJournal(path, fsync_interval=1)
        journal.attach(core)
        _submit(ns, core)
        for _ in range(3):
            _step(ns, core, vnow)
        journal.crash()
        vnow2 = [0.0]
        engine2 = _engine(ns, vnow2)
        journal2 = ns.res.RequestJournal(path, fsync_interval=1)
        rt = ns.Runtime(
            train_step=lambda state, batch: (state, {"loss": 0.0}),
            train_state={}, batch_iter=itertools.repeat({}),
            profile=ns.dp_profile("tiny", compute_s=0.03, comm_s=0.04),
            engine=engine2, cfg=ns.SpecInF(), decode_microstep_s=0.002, journal=journal2,
        )
        attached = rt.core.journal is journal2
        rt.run(num_iterations=10)
        finished = sorted(len(cr.output_tokens) for cr in rt.core.requests.values()
                          if cr.state.finished)
        return _report(rt.recovery), attached, finished, rt.metrics.virtual_time_s

    report, attached, finished, _ = _both(run, tmp_path)
    assert report[2] + report[3] > 0 and attached and finished


@pytest.mark.parametrize("decay", [8, 0])
def test_fault_decay_and_process_kill_match_reference(tmp_path, decay):
    """A request whose retry budget is spent earns it back after
    ``fault_decay_quanta`` clean quanta (with decay 0 the one late fault
    finishes it FINISHED_ERROR); and ``process/kill`` raises out of
    ``step()``."""

    def run(ns, d):
        vnow = [0.0]
        inj = ns.res.FaultInjector(seed=7, specs=(
            ns.res.FaultSpec("engine/nan_logits", probability=1.0, after=12, max_fires=1),))
        core = _engine(ns, vnow, fault_injector=inj, max_slots=1).core
        core.fault_backoff_s = 0.0
        core.fault_decay_quanta = decay
        r = core.submit(np.arange(6), ns.core.SamplingParams(max_new_tokens=48),
                        arrival_time=0.0)
        r.faults = core.max_fault_retries
        _drain(ns, core, vnow, token_budget=2)
        kill = ns.res.FaultInjector(seed=1, specs=(
            ns.res.FaultSpec("process/kill", probability=1.0, max_fires=1),))
        vnow2 = [0.0]
        core2 = _engine(ns, vnow2, fault_injector=kill).core
        core2.submit(np.arange(6), ns.core.SamplingParams(max_new_tokens=4), arrival_time=0.0)
        with pytest.raises(ns.res.ProcessKilled):
            for _ in range(10):
                _step(ns, core2, vnow2)
        return (r.state.value, list(r.output_tokens), inj.total_fires,
                core.obs.metrics.counter("fault/decays").value, kill.total_fires)

    state, _, fires, decays, kills = _both(run, tmp_path)
    assert fires == 1 and kills == 1
    assert (state != "finished_error" and decays >= 1) if decay else (
        state == "finished_error" and decays == 0)


# ---------------------------------------------------------------------------
# Checkpointer
# ---------------------------------------------------------------------------


def test_checkpoint_round_trips_bf16_bit_exact(tmp_path):
    """bf16 tensors come back bit for bit (saved as their uint16 pattern,
    not through fp32), beside fp32 / int tensors and numpy arrays, nested,
    with ``keep`` retention."""
    g = torch.Generator().manual_seed(0)
    bf = (torch.randn((3, 5, 7), generator=g) * 1e3).to(torch.bfloat16)
    bf.view(-1)[:4] = torch.tensor([float("nan"), float("inf"), -0.0, 1e-40])
    tree = {"kv": {"k": bf, "i": torch.arange(6, dtype=torch.int32)},
            "w": torch.randn(4, generator=g), "chunks": np.arange(8, dtype=np.int32)}
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save(step, tree, blocking=step != 2)
    ck.wait()
    assert ck.all_steps() == [2, 3]
    out, step = ck.restore()
    assert step == 3 and out["kv"]["k"].dtype == torch.bfloat16
    assert torch.equal(out["kv"]["k"].view(torch.int16), bf.view(torch.int16))
    assert torch.equal(out["kv"]["i"], tree["kv"]["i"]) and torch.equal(out["w"], tree["w"])
    assert isinstance(out["chunks"], np.ndarray) and (out["chunks"] == tree["chunks"]).all()
    part, _ = ck.restore({"w": torch.zeros(4)}, step=2)
    assert list(part) == ["w"] and torch.equal(part["w"], tree["w"])


def _torn(tmp_path):
    """Step 1 valid; steps 2-4 torn as a crash leaves them: no manifest, a
    manifest with ``complete: false``, a valid manifest over a truncated
    arrays file."""
    os.makedirs(tmp_path / "step_00000002")
    d3 = tmp_path / "step_00000003"
    os.makedirs(d3)
    (d3 / "manifest.json").write_text('{"step": 3, "complete": false}')
    d4 = tmp_path / "step_00000004"
    os.makedirs(d4)
    np.savez(d4 / "arrays.npz", **{"w": np.zeros((4, 4), np.float32)})
    raw = (d4 / "arrays.npz").read_bytes()
    (d4 / "arrays.npz").write_bytes(raw[: len(raw) // 2])
    (d4 / "manifest.json").write_text('{"step": 4, "complete": true, "leaves": 1}')


@pytest.mark.parametrize("case", ["torn", "fsync", "all_torn"])
def test_checkpoint_torn_saves_like_reference(tmp_path, monkeypatch, case):
    """Both checkpointers skip torn saves for the newest valid step, fsync
    the payload, the manifest and the directories, and raise when every
    candidate is torn."""

    def run(ns, d):
        os.makedirs(d)
        state = {"w": np.full((4, 4), 2.0, np.float32)}
        ck = ns.Ckpt(d)
        if case == "all_torn":
            os.makedirs(os.path.join(d, "step_00000001"))
            with open(os.path.join(d, "step_00000001", "manifest.json"), "w") as f:
                f.write('{"step": 1, "complete": true, "leaves": 1}')
            with pytest.raises(FileNotFoundError):
                ck.restore({"w": np.zeros((4, 4), np.float32)})
            return None
        calls = []
        real = os.fsync
        monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd), real(fd))[1])
        ck.save(1, state)
        monkeypatch.setattr(os, "fsync", real)
        if case == "torn":
            from pathlib import Path
            _torn(Path(d))
        got = [ck.restore({"w": np.zeros((4, 4), np.float32)}, step=s) for s in (None, 4)]
        return (len(calls) >= 4, [(np.asarray(t["w"]).tolist(), s) for t, s in got],
                ck.all_steps())

    _both(run, tmp_path)


# ---------------------------------------------------------------------------
# Warm-state snapshot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_snapshot_round_trip_warms_prefix_cache(tmp_path, dtype):
    """Snapshot the radix cache, restore into a cold engine: the prompt hits
    the warmed pages (3 of 4 skipped), the restored pages equal the saved
    ones bit for bit, and the stream equals the first engine's (and, in
    fp32, the reference's)."""
    prompt = np.arange(32) % CFG.vocab_size

    def run(ns, d, kw):
        sp = ns.core.SamplingParams(max_new_tokens=4)
        vnow = [0.0]
        engine = _engine(ns, vnow, kv_page_size=8, **kw)
        ref = engine.core.submit(prompt, sp, arrival_time=0.0)
        _drain(ns, engine.core, vnow)
        saved = ns.res.EngineSnapshot(engine, ns.Ckpt(d)).save()
        vnow2 = [0.0]
        engine2 = _engine(ns, vnow2, kv_page_size=8, **kw)
        loaded = ns.res.EngineSnapshot(engine2, ns.Ckpt(d)).restore()
        m0 = engine2.obs.metrics.counter("engine/prefill_skipped_tokens").value
        r2 = engine2.core.submit(prompt, sp, arrival_time=0.0)
        _drain(ns, engine2.core, vnow2)
        skipped = engine2.obs.metrics.counter("engine/prefill_skipped_tokens").value - m0
        return (saved, loaded, skipped, list(ref.output_tokens), list(r2.output_tokens),
                engine2.prefix_cache.hits), engine, engine2

    if dtype == torch.float32:
        got = run(J, str(tmp_path / "j"), {})[0]
        assert run(T, str(tmp_path / "t"), {})[0] == got
    got, e1, e2 = run(T, str(tmp_path / "bf16"), {"compute_dtype": dtype})
    saved, loaded, skipped, ref, out, hits = got
    assert saved and loaded > 0 and skipped == 24 and hits > 0 and out == ref
    n1, k1, v1 = e1.export_prefix_pages()
    n2, k2, v2 = e2.export_prefix_pages()
    by_chunk = {tuple(c): i for i, (_, c, _) in enumerate(n2)}
    idx = [by_chunk[tuple(c)] for _, c, _ in n1]
    assert torch.equal(k1.view(torch.int16) if dtype == torch.bfloat16 else k1,
                       (k2[:, idx].view(torch.int16) if dtype == torch.bfloat16
                        else k2[:, idx]))
    assert torch.equal(v1.float(), v2[:, idx].float())


def test_snapshot_discarded_when_it_outran_the_journal(tmp_path):
    def run(ns, d):
        os.makedirs(d)
        path = os.path.join(d, "j.jsonl")
        vnow = [0.0]
        engine = _engine(ns, vnow, kv_page_size=8)
        journal = ns.res.RequestJournal(path, fsync_interval=1)
        journal.attach(engine.core)
        engine.core.submit(np.arange(32) % CFG.vocab_size,
                           ns.core.SamplingParams(max_new_tokens=4), arrival_time=0.0)
        _drain(ns, engine.core, vnow)
        saved = ns.res.EngineSnapshot(engine, ns.Ckpt(os.path.join(d, "snap")),
                                      journal=journal).save()
        journal.close()
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        vnow2 = [0.0]
        engine2 = _engine(ns, vnow2, kv_page_size=8)
        journal2 = ns.res.RequestJournal(path, fsync_interval=1)
        snap2 = ns.res.EngineSnapshot(engine2, ns.Ckpt(os.path.join(d, "snap")),
                                      journal=journal2)
        return saved, snap2.restore(), engine2.obs.metrics.counter(
            "recovery/snapshot_discarded").value

    assert _both(run, tmp_path) == (True, 0, 1)
