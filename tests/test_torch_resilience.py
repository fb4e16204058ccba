"""Failure containment of the port against the reference: the JAX engine and
the port's (``device="cpu"``, fp32) are built on the same weights
(``params_from_numpy``), get the same submissions on the same virtual clock
and the same seeded fault schedule, and must give the same final streams,
terminal states, ``fault/*`` counters and injector fires.  Covered: the
injector's draw streams, the all-points chaos sweep on both layouts (every
clean finish equal to the fault-free run, attribution residual <= 1e-6, free
KV finite), NaN quarantine plain and speculating, the retry budget,
allocator faults on a virtual clock, revocable grants and the step-overrun
point, the overload ladder, the runtime's early resume, and the plain
attention versions' NaN positions against the reference's kernels."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import resilience as jres
from repro.configs.base import SpecDecodeConfig as JSpecCfg
from repro.configs.base import SpecInFConfig as JSpecInF
from repro.configs.base import draft_config as jdraft_config
from repro.core import SpecInFRuntime as JRuntime
from repro.core.profiles import dp_profile as jdp_profile
from repro.kernels import ops as jops
from repro.models import transformer as JT
from repro.serving import core as jcore
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch import configs
from repro_torch import resilience as tres
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SpecDecodeConfig as TSpecCfg
from repro_torch.configs import draft_config as tdraft_config
from repro_torch.configs.base import SpecInFConfig as TSpecInF
from repro_torch.core import SpecInFRuntime as TRuntime
from repro_torch.core.profiles import dp_profile as tdp_profile
from repro_torch.kernels import ops as tops
from repro_torch.serving import core as tcore
from repro_torch.serving.engine import InferenceEngine as TEngine


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


JCFG = jconfigs.smoke_config("qwen3-1.7b")
CFG = configs.smoke_config("qwen3-1.7b")
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
NP_DPARAMS = jax.tree.map(
    np.array, JT.init_params(jdraft_config(JCFG), jax.random.PRNGKey(1))
)
STEP_S = 0.002

J = types.SimpleNamespace(
    name="repro", core=jcore, res=jres, Runtime=JRuntime, SpecInF=JSpecInF,
    dp_profile=jdp_profile,
    engine=lambda vnow, spec=None, **kw: JEngine(
        JCFG, jax.tree.map(jnp.asarray, NP_PARAMS), compute_dtype=jnp.float32,
        clock=lambda: vnow[0], **_spec_kw(J, spec), **kw),
)
T = types.SimpleNamespace(
    name="repro_torch", core=tcore, res=tres, Runtime=TRuntime, SpecInF=TSpecInF,
    dp_profile=tdp_profile,
    engine=lambda vnow, spec=None, **kw: TEngine(
        CFG, params_from_numpy(NP_PARAMS, device="cpu"), compute_dtype=torch.float32,
        clock=lambda: vnow[0], device="cpu", **_spec_kw(T, spec), **kw),
)


def _spec_kw(ns, spec):
    """Engine keywords of a speculation variant: None, "draft" (the 1-layer
    draft pairing) or "ngram" (host proposer, tree verify)."""
    if spec is None:
        return {}
    if ns is J:
        if spec == "ngram":
            return {"spec": JSpecCfg(mode="greedy", proposer="ngram")}
        return {"draft_cfg": jdraft_config(JCFG), "spec": JSpecCfg(mode="greedy"),
                "draft_params": jax.tree.map(jnp.asarray, NP_DPARAMS)}
    if spec == "ngram":
        return {"spec": TSpecCfg(mode="greedy", proposer="ngram")}
    return {"draft_cfg": tdraft_config(CFG), "spec": TSpecCfg(mode="greedy"),
            "draft_params": params_from_numpy(NP_DPARAMS, device="cpu")}


def _inj(ns, seed, specs):
    return ns.res.FaultInjector(
        seed=seed, specs=[ns.res.FaultSpec(p, **kw) for p, kw in specs])


def _grant(ns, vnow, **kw):
    base = vnow[0]
    return ns.core.Grant(
        now=base, advance_clock=lambda steps, b=base: vnow.__setitem__(0, b + steps * STEP_S),
        **kw)


def _drain(ns, core, vnow, limit=1000, revocable=False, **grant_kw):
    """Step until every request finishes; ``revocable`` gives each grant a
    fresh (unarmed) ``RevocationSignal``."""
    n = 0
    while core.has_unfinished:
        if revocable:
            grant_kw["revocation"] = ns.core.RevocationSignal()
        out = core.step(_grant(ns, vnow, **grant_kw))
        if out.cost_steps == 0 and not out.admitted:
            vnow[0] += STEP_S
        n += 1
        assert n < limit, "core.step() made no progress"


def _faults(engine) -> dict:
    return {k: v.get("value", v.get("count")) for k, v in engine.obs.metrics.snapshot().items()
            if k.startswith("fault/")}


def _both(run, *args, **kw):
    """``run`` on the reference and on the port: the port's result, after
    checking it equals the reference's."""
    ref, port = run(J, *args, **kw), run(T, *args, **kw)
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# FaultInjector
# ---------------------------------------------------------------------------

INJECTOR_SPECS = {
    "two_points": (("engine/nan_logits", {"probability": 0.3}),
                   ("pool/alloc_fail", {"probability": 0.3})),
    "after_max_fires": (("engine/nan_logits", {"probability": 0.5, "after": 3,
                                               "max_fires": 2}),
                        ("core/step_overrun", {"probability": 0.7})),
    "every_point": tuple((p, {"probability": 0.2, "max_fires": 4})
                         for p in jres.FAULT_POINTS),
}


@pytest.mark.parametrize("specs", list(INJECTOR_SPECS), ids=list(INJECTOR_SPECS))
@pytest.mark.parametrize("seed", [0, 11])
def test_injector_draw_streams_equal_reference(specs, seed):
    """Same seed and specs: every consultation, extra uniform and choice
    draw, fire count and unarmed point agree with the reference's."""

    def run(ns):
        inj = _inj(ns, seed, INJECTOR_SPECS[specs])
        out = []
        for i in range(40):
            for p in ns.res.FAULT_POINTS:
                out.append(inj.should_fire(p))
                if i % 7 == 3:
                    out.append((inj.uniform(p), inj.choice(p, 5)))
        return out, inj.fires, inj.consults, inj.total_fires

    _both(run)
    assert tres.FAULT_POINTS == jres.FAULT_POINTS
    with pytest.raises(ValueError):
        tres.FaultSpec("engine/made_up_point")


# ---------------------------------------------------------------------------
# Chaos sweep: every serving fault point armed at once
# ---------------------------------------------------------------------------

SERVE_SPECS = (
    ("engine/nan_logits", {"probability": 0.05, "max_fires": 3}),
    ("pool/alloc_fail", {"probability": 0.05, "after": 2, "max_fires": 3}),
    ("core/revoke_mid_quantum", {"probability": 0.05, "max_fires": 3}),
    ("core/step_overrun", {"probability": 0.05, "max_fires": 3}),
)
CLEAN = ("length", "stop")


def _chaos(ns, seed, paged):
    """``scripts/check_chaos.py``'s serving sweep: 4 OFFLINE and 6 ONLINE
    requests drained through revocable, token-budgeted grants."""
    vnow = [0.0]
    kw = {"kv_pool_pages": 24} if paged else {"kv_page_size": 0}
    inj = None if seed is None else _inj(ns, seed, SERVE_SPECS)
    engine = ns.engine(vnow, max_slots=2, max_seq=128, fault_injector=inj, **kw)
    core = engine.core
    core.fault_backoff_s = 0.0
    rng = np.random.default_rng(0)
    reqs = [core.submit(rng.integers(0, CFG.vocab_size, 8),
                        ns.core.SamplingParams(max_new_tokens=16),
                        priority=ns.core.Priority.OFFLINE, arrival_time=0.0)
            for _ in range(4)]
    for t in np.cumsum(rng.exponential(0.01, 6)):
        reqs.append(core.submit(rng.integers(0, CFG.vocab_size, 8),
                                ns.core.SamplingParams(max_new_tokens=4, deadline_s=5.0),
                                priority=ns.core.Priority.ONLINE, arrival_time=float(t)))
    _drain(ns, core, vnow, limit=5000, revocable=True, token_budget=16,
           revoke_check_steps=2)
    return engine, reqs, inj


@pytest.mark.parametrize("paged,seed", [(True, 5), (False, 5)], ids=["paged-s5", "dense-s5"])
def test_chaos_sweep_matches_reference(paged, seed):
    def key(engine, reqs, inj):
        return ([(list(r.output_tokens), r.state.value) for r in reqs], _faults(engine),
                dict(inj.fires), engine.clock())

    je, jr, ji = _chaos(J, seed, paged)
    te, tr_, ti = _chaos(T, seed, paged)
    assert key(te, tr_, ti) == key(je, jr, ji)
    jatt, tatt = je.obs.tracer.attribution(), te.obs.tracer.attribution()
    # containment: terminal, clean finishes equal the port's fault-free run
    _, base, _ = _chaos(T, None, paged)
    assert all(r.state.finished for r in tr_)
    assert all(b.finish_reason in CLEAN for b in base)
    for r, b in zip(tr_, base):
        if r.finish_reason in CLEAN:
            assert (r.finish_reason, r.output_tokens) == (b.finish_reason, b.output_tokens)
    fires = ti.fires.get("engine/nan_logits", 0)
    assert fires > 0 and _faults(te).get("fault/nan_quarantines", 0) == fires
    # attribution telescopes and agrees with the reference's to 1e-9
    assert te.obs.tracer.dropped == 0
    order = {r.request_id: i for i, r in enumerate(tr_)}
    jorder = {r.request_id: i for i, r in enumerate(jr)}
    for rid, ra in tatt.items():
        assert abs(ra.total - (ra.finish_time - ra.arrival_time)) <= 1e-6
        ja = next(a for k, a in jatt.items() if jorder[k] == order[rid])
        for seg in ("queueing", "prefill", "decode", "preempted", "arrival_time",
                    "finish_time"):
            assert abs(getattr(ra, seg) - getattr(ja, seg)) <= 1e-9, seg
        assert ra.preemptions == ja.preemptions
    # every KV row no slot holds is finite after the drain (scrubbed)
    layers = te.cache["layers"]
    if paged:
        free = [p for p in range(te.pool.num_pages) if te.pool.refcount[p] == 0]
        held = torch.tensor(free)
        assert torch.isfinite(layers["k"][:, held]).all()
        assert torch.isfinite(layers["v"][:, held]).all()
    else:
        assert torch.isfinite(layers["k"]).all() and torch.isfinite(layers["v"]).all()


def test_draft_pairing_under_a_token_budget_matches_reference():
    """The draft-paired chaos workload of ``chip_smoke.py`` (4 slots, prompts
    of 17-90 tokens, 64-token grants, every serving fault point armed):
    slots stay PREFILLING on the draft
    side while others speculate, and re-pinning their draft index must not
    move the target's (the spec round once shared one index tensor between
    the two caches, and the port then trimmed a radix-shared page)."""

    def run(ns):
        vnow = [0.0]
        inj = _inj(ns, 1, SERVE_SPECS)
        engine = ns.engine(vnow, spec="draft", max_slots=4, max_seq=256, fault_injector=inj)
        core = engine.core
        core.fault_backoff_s = 0.0
        rng = np.random.default_rng(3)
        reqs = [core.submit(rng.integers(0, CFG.vocab_size, int(rng.integers(17, 91))),
                            ns.core.SamplingParams(max_new_tokens=24),
                            priority=ns.core.Priority.OFFLINE, arrival_time=0.0)
                for _ in range(4)]
        for t in np.cumsum(rng.exponential(0.01, 6)):
            reqs.append(core.submit(rng.integers(0, CFG.vocab_size, int(rng.integers(17, 91))),
                                    ns.core.SamplingParams(max_new_tokens=8, deadline_s=5.0),
                                    priority=ns.core.Priority.ONLINE, arrival_time=float(t)))
        _drain(ns, core, vnow, limit=5000, revocable=True, token_budget=64,
               revoke_check_steps=2)
        return ([(list(r.output_tokens), r.finish_reason) for r in reqs], _faults(engine),
                engine.prefix_cache.hits)

    streams, faults, hits = _both(run)
    assert hits > 0 and all(reason in CLEAN for _, reason in streams)
    assert faults["fault/nan_quarantines"] > 0


# ---------------------------------------------------------------------------
# NaN quarantine, retry budget, allocator faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [None, "draft", "ngram"], ids=["plain", "draft", "ngram"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_nan_quarantine_recovers_byte_identical(paged, spec):
    """One poisoned fused dispatch quarantines only the poisoned slot, which
    is scrubbed, re-queued and retried to the fault-free stream."""

    def run(ns, inj_seed):
        vnow = [0.0]
        inj = None if inj_seed is None else _inj(ns, inj_seed, (
            ("engine/nan_logits", {"probability": 1.0, "after": 1, "max_fires": 1}),))
        engine = ns.engine(vnow, spec=spec, max_slots=2, max_seq=128,
                           kv_page_size=None if paged else 0, fault_injector=inj)
        core = engine.core
        core.fault_backoff_s = 0.0
        reqs = [core.submit(np.arange(6 + i), ns.core.SamplingParams(max_new_tokens=10),
                            arrival_time=0.0) for i in range(2)]
        _drain(ns, core, vnow)
        return [list(r.output_tokens) for r in reqs], _faults(engine)

    base, _ = run(T, None)
    faulty, faults = _both(run, 3)
    assert faults["fault/nan_quarantines"] == 1 and faults["fault/requeues"] == 1
    assert faulty == base and all(len(t) == 10 for t in faulty)


def test_nan_poison_never_lands_on_a_cached_prefix():
    """A prompt of whole pages: right after its prefill the slot's last
    written position is in a radix-cached page.  The reference poisons it
    there (a shared page its scrub skips), so the retry reads the NaN again
    and quarantines outnumber fires; the port waits for a private position,
    quarantines once and finishes with the fault-free stream."""

    def run(ns, armed):
        vnow = [0.0]
        inj = _inj(ns, 1, (("engine/nan_logits", {"probability": 1.0, "max_fires": 1}),))
        engine = ns.engine(vnow, max_slots=1, max_seq=128,
                           fault_injector=inj if armed else None)
        engine.core.fault_backoff_s = 0.0
        r = engine.core.submit(np.arange(32), ns.core.SamplingParams(max_new_tokens=16),
                               arrival_time=0.0)
        _drain(ns, engine.core, vnow, token_budget=4)
        return r.finish_reason, list(r.output_tokens), inj.total_fires, _faults(engine)

    base = run(T, False)
    reason, toks, fires, faults = run(T, True)
    assert (reason, toks) == base[:2]
    assert fires == faults["fault/nan_quarantines"] == 1
    _, _, jfires, jfaults = run(J, True)
    assert jfaults["fault/nan_quarantines"] > jfires == 1


def test_retry_budget_exhaustion_finishes_error():
    def run(ns):
        vnow = [0.0]
        inj = _inj(ns, 3, (("engine/nan_logits", {"probability": 1.0}),))
        engine = ns.engine(vnow, max_slots=2, max_seq=128, fault_injector=inj)
        core = engine.core
        core.fault_backoff_s = 0.0
        r = core.submit(np.arange(6), ns.core.SamplingParams(max_new_tokens=10),
                        arrival_time=0.0)
        _drain(ns, core, vnow)
        return (r.state.value, r.finish_reason, r.faults, _faults(engine),
                engine.num_active, list(r.output_tokens))

    state, reason, faults, counters, active, _ = _both(run)
    assert (state, reason, faults, active) == ("finished_error", "error", 4, 0)
    assert counters["fault/retry_exhausted"] == 1


@pytest.mark.parametrize("lens", [[4], [7, 6, 5, 4], [5, 5, 5, 5], [6, 4, 7]],
                         ids=["one", "desc", "same", "mixed"])
def test_pool_exhaustion_blocks_admission_and_recovers(lens):
    """A 9-page pool (a request's worst case is ~3 pages): admissions block
    on genuine exhaustion and resume as slots retire, never raising, and
    every stream equals the one from a pool that never blocks."""

    def run(ns, pages):
        vnow = [0.0]
        engine = ns.engine(vnow, max_slots=2, max_seq=128, kv_page_size=8,
                           kv_pool_pages=pages)
        reqs = [engine.core.submit(np.arange(n), ns.core.SamplingParams(max_new_tokens=10),
                                   arrival_time=0.0) for n in lens]
        _drain(ns, engine.core, vnow)
        return ([(r.state.value, list(r.output_tokens)) for r in reqs], engine.pool.reserved,
                _faults(engine))

    want, _, _ = run(T, 256)
    got, reserved, faults = _both(run, 9)
    assert got == want and reserved == 0
    assert all(state == "finished_length" for state, _ in got)


def test_retry_backoff_gates_readmission():
    for ns in (J, T):
        r = ns.core.EngineRequest(prompt=np.arange(4), sampling=ns.core.SamplingParams(),
                                  priority=ns.core.Priority.ONLINE, request_id=0,
                                  arrival_time=0.0, faults=2, retry_at=0.02)
        pol = ns.core.SchedulerPolicy()
        assert not pol.eligible(r, ns.core.Grant(now=0.02 - 1e-6))
        assert pol.eligible(r, ns.core.Grant(now=0.02))


def test_alloc_fault_contained_and_byte_identical():
    """The reference's wall-clock test on a virtual clock: a failed top-up
    evicts and re-queues that slot alone, and both streams finish as in the
    fault-free run."""

    def run(ns, inj_seed):
        vnow = [0.0]
        inj = None if inj_seed is None else _inj(ns, inj_seed, (
            ("pool/alloc_fail", {"probability": 1.0, "after": 2, "max_fires": 2}),))
        engine = ns.engine(vnow, max_slots=2, max_seq=128, kv_page_size=8,
                           fault_injector=inj)
        core = engine.core
        reqs = [core.submit(np.arange(9), ns.core.SamplingParams(max_new_tokens=12),
                            arrival_time=0.0),
                core.submit(np.arange(17), ns.core.SamplingParams(max_new_tokens=12),
                            arrival_time=0.0)]
        _drain(ns, core, vnow)
        return [list(r.output_tokens) for r in reqs], _faults(engine), vnow[0]

    base, _, _ = run(T, None)
    faulty, faults, _ = _both(run, 9)
    assert faults["fault/alloc_failures"] >= 1
    assert faulty == base and all(len(t) == 12 for t in faulty)


# ---------------------------------------------------------------------------
# Revocable grants and the slow-step point
# ---------------------------------------------------------------------------


def _unit_grant(ns, clk, **kw):
    """A grant whose microstep of cost advances the clock by 1.0."""
    base = clk[0]
    kw.setdefault("now", base)
    return ns.core.Grant(advance_clock=lambda steps, _b=base: clk.__setitem__(0, _b + steps),
                         **kw)


@pytest.mark.parametrize("spec", [None, "draft"], ids=["plain", "spec"])
def test_revocation_yields_within_bound_exact_accounting(spec):
    def run(ns, revoke_at):
        clk = [0.0]
        engine = ns.engine(clk, spec=spec, max_slots=1, max_seq=128)
        core = engine.core
        r = core.submit(np.arange(8), ns.core.SamplingParams(max_new_tokens=24),
                        arrival_time=0.0)
        sig = ns.core.RevocationSignal()
        sig.arm(revoke_at)
        outs = []
        while not r.state.finished:
            s = sig if not sig.revoked else None
            out = core.step(_unit_grant(ns, clk, revocation=s, revoke_check_steps=1))
            outs.append((out.k, out.gamma, out.cost_steps, out.revoked))
            assert len(outs) < 100
        return list(r.output_tokens), outs, _faults(engine)

    base, outs0, _ = run(T, float("inf"))
    assert len(base) == 24 and not any(o[3] for o in outs0)
    toks, outs, faults = _both(run, outs0[0][2] + 2.0)
    (k, _, cost, _), = [o for o in outs if o[3]]
    per = 1.0 if spec is None else outs0[1][2] / outs0[1][0]
    assert cost == pytest.approx(k * per) and k < outs0[1][0] and k * per <= 2.0 + per
    assert faults["fault/revocations"] == 1
    assert toks == base


@pytest.mark.parametrize("case", ["unarmed", "mid_quantum", "overrun"])
def test_revocation_and_overrun_points_match_reference(case):
    """An unarmed signal gives the single dispatch's bytes, quantum shapes
    and end time; ``core/revoke_mid_quantum`` trips the signal between
    sub-dispatches; ``core/step_overrun`` inflates one quantum's cost and
    never its tokens."""

    def run(ns, inj_on):
        clk = [0.0]
        specs = {"mid_quantum": (("core/revoke_mid_quantum", {"probability": 1.0, "after": 1,
                                                              "max_fires": 1}),),
                 "overrun": (("core/step_overrun", {"probability": 1.0, "max_fires": 1}),)}
        inj = _inj(ns, 2, specs[case]) if inj_on and case in specs else None
        engine = ns.engine(clk, max_slots=1 if case == "mid_quantum" else 2, max_seq=128,
                           fault_injector=inj)
        core = engine.core
        r = core.submit(np.arange(8), ns.core.SamplingParams(max_new_tokens=16),
                        arrival_time=0.0)
        sig = ns.core.RevocationSignal()
        outs = []
        while not r.state.finished:
            revocable = case == "mid_quantum" or (case == "unarmed" and inj_on)
            out = core.step(_unit_grant(ns, clk, revocation=sig if revocable else None,
                                        revoke_check_steps=2 if case == "unarmed" else 1))
            outs.append((out.k, out.cost_steps, out.revoked))
            if sig.revoked:
                break
        return list(r.output_tokens), outs, clk[0], sig.revoked, sig.reason, _faults(engine)

    base = run(T, False)
    got = _both(run, True)
    if case == "unarmed":
        assert got[:3] == base[:3]
    elif case == "mid_quantum":
        assert got[3] and got[4] == "injected_revocation"
        assert got[5]["fault/revocations"] == 1
    else:
        assert got[0] == base[0] and got[2] > base[2]
        assert got[1][0][1] > base[1][0][1] and got[1][1:] == base[1][1:]


# ---------------------------------------------------------------------------
# Overload ladder
# ---------------------------------------------------------------------------


def _ladder_core(ns, n_offline=10, **eng_kw):
    clk = [0.0]
    core = ns.engine(clk, max_slots=2, max_seq=128, **eng_kw).core
    core.ladder = ns.res.OverloadLadder(ns.res.LadderConfig(
        high_queue_depth=4, low_queue_depth=1, up_dwell=2, down_dwell=3,
        offline_keep_depth=2,
    ))
    for _ in range(n_offline):
        core.submit(np.arange(5), ns.core.SamplingParams(max_new_tokens=2),
                    priority=ns.core.Priority.OFFLINE, arrival_time=0.0)
    return core


@pytest.mark.parametrize("case", ["escalate", "hysteresis", "shed_online", "step_loop"])
def test_ladder_matches_reference(case):
    def run(ns):
        stages = []
        if case == "escalate":
            core = _ladder_core(ns)
            for _ in range(6):
                core.ladder.update(core, ns.core.Grant(now=0.0))
                stages.append(int(core.ladder.stage))
            stages.append(len(core.waiting[ns.core.Priority.OFFLINE]))
        elif case == "hysteresis":
            core = _ladder_core(ns, n_offline=0)
            core.ladder.stage = ns.res.LadderStage.SPEC_OFF
            for i in range(9):
                for _ in range(10 if i < 6 and i % 2 else 0):
                    core.submit(np.arange(4), ns.core.SamplingParams(max_new_tokens=1),
                                priority=ns.core.Priority.OFFLINE, arrival_time=0.0)
                core.ladder.update(core, ns.core.Grant(now=0.0))
                core.waiting[ns.core.Priority.OFFLINE].clear()
                stages.append(int(core.ladder.stage))
        elif case == "shed_online":
            core = _ladder_core(ns, n_offline=0)
            core.ladder.stage = ns.res.LadderStage.SHED_ONLINE
            reqs = [core.submit(np.arange(4), ns.core.SamplingParams(max_new_tokens=2,
                                                                     deadline_s=d),
                                priority=ns.core.Priority.ONLINE, arrival_time=0.0)
                    for d in (1.0, 100.0)]
            core.ladder.update(core, ns.core.Grant(now=1.5))
            plan = ns.core.StepPlan(k=8, gamma=4, cost_steps=40.0)
            core.ladder.apply(core, ns.core.Grant(now=1.5), plan)
            stages += [r.state.value for r in reqs] + [plan.gamma, plan.k, plan.cost_steps]
        else:
            core = _ladder_core(ns, n_offline=16)
            n = 0
            while core.has_unfinished:
                core.step(ns.core.Grant(now=float(n)))
                n += 1
                assert n < 200
            stages.append(n)
        return stages, _faults(core.engine)

    stages, faults = _both(run)
    if case == "escalate":
        assert stages == [0, 1, 1, 2, 2, 3, 2] and faults["fault/shed/offline"] == 8
    elif case == "hysteresis":
        assert stages[:6] == [1] * 6 and stages[-1] == 0
    elif case == "shed_online":
        assert stages == ["finished_expired", "waiting", None, 1, 1.0]
    else:
        assert faults["fault/shed/offline"] > 0 and faults["fault/ladder_escalations"] >= 3


# ---------------------------------------------------------------------------
# Runtime: early resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("check_steps", [0, 1])
def test_runtime_early_resume_matches_reference(check_steps):
    """Training resumes inside a bubble: the grant yields within one
    sub-dispatch on the virtual clock, the virtual step time equals the
    no-serving baseline, and overruns, counters and streams equal the
    reference's."""

    def run(ns):
        clk = [0.0]
        eng = ns.engine(clk, max_slots=2, max_seq=128)
        reqs = [eng.core.submit(np.arange(8), ns.core.SamplingParams(max_new_tokens=1000),
                                arrival_time=0.0) for _ in range(2)]
        inj = _inj(ns, 4, (("runtime/early_resume", {"probability": 0.5, "max_fires": 2}),))
        rt = ns.Runtime(
            train_step=lambda s, b: (s, {}), train_state=None,
            batch_iter=iter(lambda: {}, None),
            profile=ns.dp_profile("tiny", compute_s=0.02, comm_s=0.04), engine=eng,
            cfg=ns.SpecInF(revocation_check_steps=check_steps), decode_microstep_s=0.004,
            faults=inj,
        )
        rt.run(num_iterations=4)
        h = eng.obs.metrics.histogram("fault/revocation_overrun_s")
        return (h.values(), _faults(eng), dict(inj.fires), rt.metrics.virtual_time_s,
                rt.monitor.interrupts, [list(r.output_tokens) for r in reqs])

    overruns, faults, fires, vt, interrupts, _ = _both(run)
    assert fires["runtime/early_resume"] == faults["fault/early_resume"] == interrupts
    assert interrupts >= 1 and max(overruns) <= 0.004 * 3 + 1e-9
    assert vt == pytest.approx(4 * (0.02 + 0.04 * 0.7), abs=1e-12)


# ---------------------------------------------------------------------------
# Plain attention versions: NaN positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["paged_decode_attention", "decode_attention",
                                    "paged_prefill_chunk_attention",
                                    "prefill_chunk_attention"])
def test_plain_versions_propagate_nan_like_reference(kernel):
    """A NaN at one live K position of slot 1: the port's plain version is
    non-finite exactly where the reference's kernel (interpret mode) is,
    and other slots stay finite."""
    rng = np.random.default_rng(0)
    b, h, kvh, hd, page, ncols, c = 3, 4, 2, 16, 8, 4, 8
    paged = kernel.startswith("paged")
    if paged:
        k = rng.standard_normal((1 + b * ncols, page, kvh, hd)).astype(np.float32)
        bt = np.concatenate([rng.permutation(np.arange(1, 1 + b * ncols)).reshape(b, ncols),
                             np.zeros((b, 1), np.int64)], 1).astype(np.int32)
        k[bt[1, 1], 3, 1, 2] = np.nan  # slot 1, position 11
        kv = (k, rng.standard_normal(k.shape).astype(np.float32), bt)
    else:
        k = rng.standard_normal((b, ncols * page, kvh, hd)).astype(np.float32)
        k[1, 11, 1, 2] = np.nan
        kv = (k, rng.standard_normal(k.shape).astype(np.float32))
    if "decode" in kernel:
        q = rng.standard_normal((b, h, hd)).astype(np.float32)
        rest = (np.asarray([20, 20, 0], np.int32),)
    else:
        q = rng.standard_normal((b, c, h, hd)).astype(np.float32)
        # slot 1's chunk starts at 8: rows 0-2 do not see position 11
        rest = (np.asarray([4, 8, 0], np.int32), np.asarray([8, 6, 3], np.int32))
    args = (q, *kv, *rest)
    ref = np.asarray(getattr(jops, kernel)(*map(jnp.asarray, args), impl="pallas"))
    out = getattr(tops, kernel)(*[torch.from_numpy(a) for a in args], impl="torch").numpy()
    assert np.array_equal(~np.isfinite(out), ~np.isfinite(ref))
    assert (~np.isfinite(out[1])).any() and np.isfinite(out[[0, 2]]).all()
