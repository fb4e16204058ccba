"""Seeded chaos sweep over the port's failure-containment machinery (the
counterpart of ``scripts/check_chaos.py``).

Three deterministic sweeps over the port's ``EngineCore``, all on the
virtual clock so every run is reproducible from its seed alone.  The
engines serve the 2-layer smoke ``qwen3-1.7b`` from the port's seeded
``torch.Generator`` init, in fp32 (a bf16 re-prefill rounds otherwise than
the decode it replaces, which would break byte-identity for a reason that
is not a containment fault).

* **Serving sweep** -- a mixed online/offline workload drains through
  ``EngineCore.step()`` with every serving-side fault point armed at
  once (NaN logits, transient page-allocation failures, mid-quantum
  revocation, slow-step overruns).  Pass criteria per seed:

  - zero crashes: the drain completes without an exception or a hang;
  - containment: every request reaches a terminal state, and every
    request that finished normally (not shed/expired, not past its
    retry budget) produced a token stream BYTE-IDENTICAL to the
    fault-free reference run;
  - attribution: the step tracer's SLO segments still telescope to
    end-to-end latency (max residual <= 1e-6) and no events dropped.

* **Early-resume sweep** -- a collocated ``SpecInFRuntime`` run where
  training resumes before the predicted bubble end.  The armed
  revocation must yield within one sub-dispatch of
  ``revocation_check_steps`` microsteps (3x slack for window
  granularity), and training's virtual step time must equal the
  no-serving baseline exactly.

* **Recovery sweep** -- the same mixed workload with ``process/kill``
  armed and a write-ahead journal attached.  Each kill abandons the
  engine, truncates the journal to its fsynced prefix, rebuilds a fresh
  engine and replays.  Pass criteria per seed, for BOTH the paged and
  dense KV layouts: exactly one durable finish record a request; every
  clean finish's journaled stream equal to the never-killed run's;
  attribution still telescopes on the final incarnation's tracer.

    PYTHONPATH=src python scripts/torch_check_chaos.py              # cuda
    PYTHONPATH=src python scripts/torch_check_chaos.py --device cpu
    PYTHONPATH=src python scripts/torch_check_chaos.py --device cpu --only recovery

Exits 1 if any check fails.
"""
from __future__ import annotations

import os
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SpecInFConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.resilience import (  # noqa: E402
    FaultInjector,
    FaultSpec,
    ProcessKilled,
    RequestJournal,
    read_journal,
)
from repro_torch.serving.core import (  # noqa: E402
    Grant,
    Priority,
    RevocationSignal,
    SamplingParams,
)
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

SERVE_SEEDS = (1, 2, 3, 4, 5)
RESUME_SEEDS = (1, 2, 3)
RECOVERY_SEEDS = (1, 2, 3, 4, 5)
STEP_S = 0.002
MAX_QUANTA = 5000  # drain cap: exceeding it counts as a hang (a crash)
MAX_RESTARTS = 10  # a kill budget of 3 can never need more
ATTRIBUTION_TOL = 1e-6

CFG = configs.smoke_config("qwen3-1.7b")

#: every serving-side fault point, armed together -- containment domains
#: must hold when faults overlap, not just one family at a time
SERVE_SPECS = (
    FaultSpec("engine/nan_logits", probability=0.05, max_fires=3),
    FaultSpec("pool/alloc_fail", probability=0.05, after=2, max_fires=3),
    FaultSpec("core/revoke_mid_quantum", probability=0.05, max_fires=3),
    FaultSpec("core/step_overrun", probability=0.05, max_fires=3),
)

#: finish reasons whose token streams must match the fault-free run;
#: "expired" (shed / queue deadline) and "error" (retry budget spent)
#: are legitimate chaos outcomes and are reported, not compared
CLEAN_REASONS = ("length", "stop")


def init_params(device):
    """The smoke config's weights from the port's seeded init."""
    return T.init_params(CFG, torch.Generator(device=device).manual_seed(0))


def _engine(params, device, vnow, injector=None, paged=True):
    layout = {"kv_pool_pages": 24} if paged else {"kv_page_size": 0}
    return InferenceEngine(CFG, params, max_slots=2, max_seq=128, clock=lambda: vnow[0],
                           compute_dtype=torch.float32, device=device,
                           fault_injector=injector, **layout)


def _submit_workload(core):
    """4 OFFLINE requests at t = 0, then 6 ONLINE Poisson arrivals."""
    rng = np.random.default_rng(0)
    reqs = [
        core.submit(
            rng.integers(0, CFG.vocab_size, 8),
            SamplingParams(max_new_tokens=16),
            priority=Priority.OFFLINE, arrival_time=0.0,
        )
        for _ in range(4)
    ]
    for t in np.cumsum(rng.exponential(0.01, 6)):
        reqs.append(core.submit(
            rng.integers(0, CFG.vocab_size, 8),
            SamplingParams(max_new_tokens=4, deadline_s=5.0),
            priority=Priority.ONLINE, arrival_time=float(t),
        ))
    return reqs


def _drain(core, vnow):
    quanta = 0
    while core.has_unfinished:
        quanta += 1
        if quanta > MAX_QUANTA:
            raise RuntimeError(
                f"drain exceeded {MAX_QUANTA} quanta — containment hang"
            )
        base = vnow[0]
        out = core.step(Grant(
            now=base, token_budget=16,
            revocation=RevocationSignal(), revoke_check_steps=2,
            advance_clock=lambda steps, b=base: vnow.__setitem__(
                0, b + steps * STEP_S
            ),
        ))
        if out.cost_steps == 0 and not out.admitted:
            vnow[0] += STEP_S  # idle until the next arrival


def serve_run(params, device, injector, paged=True):
    """Drain the fixed mixed workload; returns (engine, requests)."""
    vnow = [0.0]
    engine = _engine(params, device, vnow, injector, paged)
    engine.core.fault_backoff_s = 0.0  # virtual-clock run: retry immediately
    reqs = _submit_workload(engine.core)
    _drain(engine.core, vnow)
    return engine, reqs


def check_attribution(engine) -> float:
    tr = engine.obs.tracer
    if tr.dropped:
        raise AssertionError(f"tracer dropped {tr.dropped} events")
    resid = [
        abs(ra.total - (ra.finish_time - ra.arrival_time))
        for ra in tr.attribution().values()
        if ra.finish_time is not None
    ]
    return max(resid) if resid else 0.0


def serve_sweep(params, device) -> int:
    _, ref = serve_run(params, device, None)
    if not all(r.finish_reason in CLEAN_REASONS for r in ref):
        raise RuntimeError("fault-free reference must finish every request normally")
    failures = 0
    for seed in SERVE_SEEDS:
        inj = FaultInjector(seed=seed, specs=SERVE_SPECS)
        try:
            engine, reqs = serve_run(params, device, inj)
        except Exception:
            traceback.print_exc()
            print(f"FAIL seed={seed}: chaos run crashed")
            failures += 1
            continue
        unfinished = [r for r in reqs if not r.state.finished]
        mismatched = [
            i for i, (r, rr) in enumerate(zip(reqs, ref))
            if r.finish_reason in CLEAN_REASONS
            and (r.finish_reason != rr.finish_reason
                 or r.output_tokens != rr.output_tokens)
        ]
        resid = check_attribution(engine)
        clean = sum(r.finish_reason in CLEAN_REASONS for r in reqs)
        errors = sum(r.finish_reason == "error" for r in reqs)
        expired = sum(r.finish_reason == "expired" for r in reqs)
        print(
            f"seed={seed}: fires={inj.fires} clean={clean}/{len(reqs)} "
            f"error={errors} expired={expired} "
            f"attribution_residual={resid:.2e}"
        )
        if unfinished:
            print(f"FAIL seed={seed}: {len(unfinished)} requests never "
                  f"reached a terminal state")
            failures += 1
        if mismatched:
            print(f"FAIL seed={seed}: requests {mismatched} finished "
                  f"normally but diverged from the fault-free reference")
            failures += 1
        if resid > ATTRIBUTION_TOL:
            print(f"FAIL seed={seed}: SLO attribution residual {resid} "
                  f"> {ATTRIBUTION_TOL}")
            failures += 1
    return failures


def resume_sweep(params, device) -> int:
    from repro_torch.core import SpecInFRuntime
    from repro_torch.core.profiles import dp_profile

    iterations = 4
    compute_s, comm_s = 0.02, 0.04
    baseline_s = iterations * (compute_s + comm_s * 0.7)  # overlap 0.3
    failures = 0
    for seed in RESUME_SEEDS:
        eng = InferenceEngine(CFG, params, max_slots=2, max_seq=128,
                              compute_dtype=torch.float32, device=device)
        for _ in range(2):
            eng.core.submit(np.arange(8), SamplingParams(max_new_tokens=1000),
                            priority=Priority.OFFLINE)
        inj = FaultInjector(seed=seed, specs=(
            FaultSpec("runtime/early_resume", probability=0.5, max_fires=2),
        ))
        rt = SpecInFRuntime(
            train_step=lambda s, b: (s, {}),
            train_state=None,
            batch_iter=iter(lambda: {}, None),
            profile=dp_profile("tiny", compute_s=compute_s, comm_s=comm_s),
            engine=eng,
            cfg=SpecInFConfig(),
            decode_microstep_s=0.004,
            faults=inj,
        )
        try:
            rt.run(num_iterations=iterations)
        except Exception:
            traceback.print_exc()
            print(f"FAIL seed={seed}: early-resume run crashed")
            failures += 1
            continue
        m = eng.obs.metrics
        fires = inj.fires.get("runtime/early_resume", 0)
        resumed = m.counter("fault/early_resume").value
        h = m.histogram("fault/revocation_overrun_s")
        worst = max(h.values()) if h.count else 0.0
        bound = rt.decode_microstep_s * 3  # one sub-dispatch + granularity
        print(f"seed={seed}: early_resumes={resumed}/{fires} "
              f"worst_overrun={worst * 1e3:.3f} ms "
              f"(bound {bound * 1e3:.1f} ms) "
              f"train_virtual={rt.metrics.virtual_time_s:.4f} s "
              f"(baseline {baseline_s:.4f} s)")
        if resumed != fires:
            print(f"FAIL seed={seed}: {fires} injected early resumes but "
                  f"{resumed} recorded")
            failures += 1
        if worst > bound + 1e-9:
            print(f"FAIL seed={seed}: revocation overran the yield bound")
            failures += 1
        if abs(rt.metrics.virtual_time_s - baseline_s) > 1e-9:
            print(f"FAIL seed={seed}: training step time diverged from "
                  f"the no-serving baseline under revocation")
            failures += 1
        if rt.metrics.train_iterations != iterations:
            print(f"FAIL seed={seed}: training did not run to completion")
            failures += 1
    return failures


# ---------------------------------------------------------------------------
# Recovery sweep: kill -> restore -> drain
# ---------------------------------------------------------------------------


def _journal_streams(path):
    """(tokens, finish-records) per request id from the durable journal."""
    records, _ = read_journal(path)
    toks: dict = {}
    fins: dict = {}
    for rec in records:
        if rec["k"] == "delta":
            cur = toks.setdefault(rec["rid"], [])
            if rec["tot"] == len(cur) + len(rec["tok"]):
                cur.extend(rec["tok"])
        elif rec["k"] == "fin":
            fins.setdefault(rec["rid"], []).append(rec)
    return toks, fins


def kill_run(params, device, seed, path, paged):
    """Run the workload to completion across simulated process deaths.

    Returns ``(final_engine, rid0, restarts, kills)``: each ProcessKilled
    abandons the engine, truncates the journal to its fsynced prefix, and
    rebuilds from replay -- the workload is submitted exactly once, in the
    first incarnation."""
    inj = FaultInjector(seed=seed, specs=(
        FaultSpec("process/kill", probability=0.05, max_fires=3),
    ))
    restarts = 0
    rid0 = None
    while True:
        vnow = [0.0]
        engine = _engine(params, device, vnow, inj, paged)
        core = engine.core
        core.fault_backoff_s = 0.0
        journal = RequestJournal(path, fsync_interval=4)
        journal.recover_into(core)
        journal.attach(core)
        if rid0 is None:
            rid0 = _submit_workload(core)[0].request_id
        try:
            _drain(core, vnow)
        except ProcessKilled:
            journal.crash()
            restarts += 1
            if restarts > MAX_RESTARTS:
                raise RuntimeError("kill/restore loop did not converge")
            continue
        journal.close()
        return engine, rid0, restarts, inj.total_fires


def recovery_sweep(params, device, tmpdir) -> int:
    failures = 0
    total_kills = 0
    for paged in (True, False):
        layout = "paged" if paged else "dense"
        _, ref = serve_run(params, device, None, paged)
        if not all(r.finish_reason in CLEAN_REASONS for r in ref):
            raise RuntimeError("kill-free reference must finish every request normally")
        for seed in RECOVERY_SEEDS:
            path = os.path.join(tmpdir, f"journal_{layout}_s{seed}.jsonl")
            try:
                engine, rid0, restarts, kills = kill_run(params, device, seed, path, paged)
            except Exception:
                traceback.print_exc()
                print(f"FAIL {layout} seed={seed}: kill/restore crashed")
                failures += 1
                continue
            total_kills += kills
            toks, fins = _journal_streams(path)
            lost = [i for i in range(len(ref))
                    if len(fins.get(rid0 + i, [])) == 0]
            dup = [i for i in range(len(ref))
                   if len(fins.get(rid0 + i, [])) > 1]
            mismatched = [
                i for i, rr in enumerate(ref)
                if fins.get(rid0 + i)
                and fins[rid0 + i][0]["rsn"] in CLEAN_REASONS
                and (fins[rid0 + i][0]["rsn"] != rr.finish_reason
                     or toks.get(rid0 + i, []) != rr.output_tokens)
            ]
            resid = check_attribution(engine)
            print(
                f"{layout} seed={seed}: kills={kills} restarts={restarts} "
                f"finished={len(ref) - len(lost)}/{len(ref)} "
                f"attribution_residual={resid:.2e}"
            )
            if lost:
                print(f"FAIL {layout} seed={seed}: requests {lost} have no "
                      f"durable finish record (lost)")
                failures += 1
            if dup:
                print(f"FAIL {layout} seed={seed}: requests {dup} finished "
                      f"more than once (duplicated)")
                failures += 1
            if mismatched:
                print(f"FAIL {layout} seed={seed}: requests {mismatched} "
                      f"finished normally but diverged from the "
                      f"uninterrupted reference")
                failures += 1
            if resid > ATTRIBUTION_TOL:
                print(f"FAIL {layout} seed={seed}: SLO attribution residual "
                      f"{resid} > {ATTRIBUTION_TOL}")
                failures += 1
    if total_kills == 0:
        print("FAIL recovery: no process/kill ever fired — the sweep "
              "exercised nothing")
        failures += 1
    return failures


def main(argv=None) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument(
        "--only", choices=("serve", "resume", "recovery"), default=None,
        help="run a single sweep (default: all three)",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    params = init_params(device)
    failures = 0
    if args.only in (None, "serve"):
        print(f"serving chaos sweep: seeds {SERVE_SEEDS}, "
              f"{len(SERVE_SPECS)} fault points armed")
        failures += serve_sweep(params, device)
    if args.only in (None, "resume"):
        print(f"early-resume sweep: seeds {RESUME_SEEDS}")
        failures += resume_sweep(params, device)
    if args.only in (None, "recovery"):
        print(f"recovery sweep: seeds {RECOVERY_SEEDS}, process/kill armed, "
              f"paged + dense")
        with tempfile.TemporaryDirectory() as tmpdir:
            failures += recovery_sweep(params, device, tmpdir)
    if failures:
        print(f"FAIL: {failures} chaos check(s) failed")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
