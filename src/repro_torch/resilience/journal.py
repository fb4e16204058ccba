"""Write-ahead request journal + deterministic replay recovery (own copy of
``repro.resilience.journal``).

``RequestJournal`` makes the request-lifecycle state of an ``EngineCore``
crash-durable: every accepted request is journaled at submit, at each
state transition, at every token delta, and at finish, as append-only
JSONL.  A killed engine restarts by replaying the journal into a fresh
core (``recover_into``): WAITING requests re-enter their queue,
mid-flight requests (PREFILLING/RUNNING/PREEMPTED at the crash) re-enter
as PREEMPTED carrying prompt + generated-so-far, and the existing
byte-identical preemption-resume machinery (DESIGN.md §6) re-prefills
them — the radix prefix cache (optionally pre-warmed from a
``snapshot.EngineSnapshot``) absorbs most of the re-prefill cost.

Durability contract:

* Appends are fsync'd on a **group-commit interval** (every
  ``fsync_interval`` records).  A crash loses at most the un-fsynced
  suffix — bounded by the interval, asserted (not assumed) in
  ``tests/test_recovery.py``.  Lost deltas are regenerated byte-
  identically on replay-resume (greedy decode is deterministic).
* Records are **idempotent by request id**: duplicate submits are
  ignored, token deltas carry the cumulative total (a replayed duplicate
  is a no-op), and the first finish record for an id wins.  A finish
  that never reached disk simply re-runs to the same bytes.
* Replay **restamps** ``arrival_time`` / ``retry_at`` /
  ``first_token_time`` by ``restore_clock - last_journaled_t``, so a
  request's consumed deadline age carries across the restart instead of
  the whole queue mass-expiring (or deadlines silently resetting).

The journal is the sole source of truth for request state; snapshots
(``resilience/snapshot.py``) are derived KV cache only and are never
required for correctness.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

__all__ = ["RequestJournal", "RecoveryReport", "read_journal"]

#: journal format version (the ``meta`` record)
JOURNAL_VERSION = 1

#: lifecycle states that imply the request held (or holds) a slot — on
#: replay these re-enter as PREEMPTED instead of WAITING
_INFLIGHT_STATES = ("prefilling", "running", "preempted")


def read_journal(path: str) -> tuple[list, int]:
    """Parse the durable prefix of a journal: ``(records, torn)``.

    A real crash can tear the final line mid-write; parsing stops at the
    first unterminated or undecodable line (everything after it is
    suspect) and reports it in ``torn`` instead of raising."""
    records: list = []
    torn = 0
    if not os.path.exists(path):
        return records, torn
    with open(path, "rb") as f:
        for line in f:
            if not line.endswith(b"\n"):
                torn = 1
                break
            try:
                records.append(json.loads(line))
            except ValueError:
                torn = 1
                break
    return records, torn


@dataclasses.dataclass
class RecoveryReport:
    """What ``recover_into`` did — surfaced in serve summaries/benches."""

    replayed_records: int = 0
    replayed_tokens: int = 0
    requeued_waiting: int = 0
    resumed_inflight: int = 0
    skipped_finished: int = 0
    skipped_present: int = 0  # double-restore idempotence: already live
    skipped_unfit: int = 0  # no longer admissible on this engine config
    torn_tail: int = 0
    duration_s: float = 0.0
    clock_shift: float = 0.0

    @property
    def restored(self) -> int:
        return self.requeued_waiting + self.resumed_inflight


class RequestJournal:
    """Append-only JSONL write-ahead log for one ``EngineCore``.

    Record kinds (compact keys; one JSON object per line):

    ==========  =========================================================
    ``meta``    file header: ``{"k":"meta","v":1}`` (fsync'd at creation)
    ``submit``  request accepted: prompt, sampling, priority, arrival
    ``tr``      lifecycle transition: state + fault/backoff bookkeeping
    ``delta``   accepted-token delta + cumulative total (idempotence key)
    ``fin``     terminal state: finish reason + final total
    ==========  =========================================================

    ``attach(core)`` wires the journal into the core's submit/step/abort
    paths; ``recover_into(core)`` replays an existing file into a fresh
    core.  ``crash()`` simulates process death for chaos tests: the file
    is truncated back to its last fsynced offset, modelling the loss of
    everything the OS had not yet made durable."""

    def __init__(
        self,
        path: str,
        *,
        fsync_interval: int = 8,
        metrics=None,
    ):
        self.path = str(path)
        self.fsync_interval = max(int(fsync_interval), 1)
        self.metrics = metrics
        fresh = (
            not os.path.exists(self.path)
            or os.path.getsize(self.path) == 0
        )
        self._f = open(self.path, "ab")
        self._synced_offset = self._f.tell()
        self._pending = 0  # appends since the last fsync
        self.appends = 0
        self.fsyncs = 0
        # per-request dedup state for this incarnation (seeded by
        # recover_into when resuming an existing file)
        self._known: set = set()  # rids with a submit record
        self._finished: set = set()  # rids with a fin record
        self._last_tot: dict = {}  # rid -> journaled cumulative total
        self._last_sig: dict = {}  # rid -> (state, faults, retry_at)
        if fresh:
            self._append({"k": "meta", "v": JOURNAL_VERSION})
            self.commit()

    # ------------------------------------------------------------------
    # Append side
    # ------------------------------------------------------------------
    def _append(self, rec: dict) -> None:
        line = (json.dumps(rec, separators=(",", ":")) + "\n").encode()
        self._f.write(line)
        self._pending += 1
        self.appends += 1
        if self.metrics is not None:
            self.metrics.counter("journal/appends").inc()
            self.metrics.counter("journal/bytes").inc(len(line))
        if self._pending >= self.fsync_interval:
            self.commit()

    def commit(self) -> None:
        """Group-commit barrier: flush + fsync everything appended so far.
        Records are durable (survive ``crash()``) only past this point."""
        if self._f.closed:
            return
        self._f.flush()
        os.fsync(self._f.fileno())
        self._synced_offset = self._f.tell()
        self._pending = 0
        self.fsyncs += 1
        if self.metrics is not None:
            self.metrics.counter("journal/fsyncs").inc()

    @property
    def pending_records(self) -> int:
        """Appended-but-not-fsynced records — the crash loss window
        (bounded by ``fsync_interval`` by construction)."""
        return self._pending

    def close(self) -> None:
        if not self._f.closed:
            self.commit()
            self._f.close()

    def crash(self) -> None:
        """Simulate process death: everything after the last fsync is
        lost.  The file is truncated to the durable prefix; the journal
        object is unusable afterwards (like the process that owned it)."""
        if not self._f.closed:
            self._f.close()  # flush() without fsync is NOT durable
        with open(self.path, "r+b") as f:
            f.truncate(self._synced_offset)

    # ------------------------------------------------------------------
    # EngineCore hooks
    # ------------------------------------------------------------------
    def attach(self, core) -> None:
        """Wire this journal into ``core`` (sets ``core.journal``).  Call
        after ``recover_into`` when resuming, so the dedup state already
        reflects the replayed records."""
        core.journal = self
        if self.metrics is None:
            self.metrics = core.obs.metrics

    def record_submit(self, cr, now: float) -> None:
        rid = cr.request_id
        if rid in self._known:
            return  # idempotent by request id
        self._known.add(rid)
        self._last_tot[rid] = len(cr.output_tokens)
        self._last_sig[rid] = (cr.state.value, cr.faults, cr.retry_at)
        s = cr.sampling
        self._append({
            "k": "submit", "rid": rid, "t": float(now),
            "prompt": [int(t) for t in cr.prompt],
            "mx": int(s.max_new_tokens),
            "stop": [int(t) for t in s.stop_token_ids],
            "dl": s.deadline_s,
            "pri": cr.priority.value,
            "arr": float(cr.arrival_time),
        })

    def _record_delta(self, cr, now: float) -> None:
        rid = cr.request_id
        base = self._last_tot.get(rid, 0)
        tot = len(cr.output_tokens)
        if tot <= base:
            return
        self._last_tot[rid] = tot
        self._append({
            "k": "delta", "rid": rid, "t": float(now),
            "tok": [int(t) for t in cr.output_tokens[base:]],
            "tot": tot,
            "ftt": (
                None if cr.first_token_time is None
                else float(cr.first_token_time)
            ),
        })

    def record_finish(self, cr, now: float) -> None:
        """Terminal record (also the ``abort()`` hook, which runs outside
        ``step()``)."""
        rid = cr.request_id
        if rid not in self._known or rid in self._finished:
            return
        self._record_delta(cr, now)
        self._finished.add(rid)
        self._append({
            "k": "fin", "rid": rid, "t": float(now),
            "rsn": cr.finish_reason, "tot": len(cr.output_tokens),
        })

    def record_step(self, core, out) -> None:
        """End-of-quantum hook: journal this step's token deltas, state
        transitions, and finishes for every touched request, then apply
        the group-commit policy."""
        now = core.engine.clock()
        for ro in out.outputs:
            cr = core.requests.get(ro.request_id)
            if cr is None or ro.request_id not in self._known:
                continue  # legacy-shim requests bypass submit()
            self._record_delta(cr, now)
            if cr.state.finished:
                self.record_finish(cr, now)
                continue
            sig = (cr.state.value, cr.faults, cr.retry_at)
            if self._last_sig.get(ro.request_id) != sig:
                self._last_sig[ro.request_id] = sig
                self._append({
                    "k": "tr", "rid": ro.request_id, "t": float(now),
                    "st": cr.state.value, "f": int(cr.faults),
                    "ra": float(cr.retry_at),
                })

    # ------------------------------------------------------------------
    # Replay side
    # ------------------------------------------------------------------
    def recover_into(self, core) -> RecoveryReport:
        """Replay the durable journal prefix into ``core``.

        WAITING requests re-enter their priority queue in submission
        order; mid-flight requests re-enter as PREEMPTED at the FRONT of
        their class with prompt + generated-so-far (resume is then the
        PR-4 byte-identical path).  Durably-finished ids and ids already
        live in ``core`` are skipped, so replay — and a double restore —
        is idempotent.  All engine-clock stamps are shifted onto the
        restored clock (satellite: deadlines age, they don't reset)."""
        # imported here: repro_torch.serving.core imports this package
        # lazily, and importing it at module scope would complete the cycle
        from repro_torch.serving.core import (
            EngineRequest, Priority, RequestState, SamplingParams,
        )
        from repro_torch.serving.engine import Request, advance_request_ids

        t_wall = time.monotonic()
        if not self._f.closed:
            self._f.flush()
        report = RecoveryReport()
        records, report.torn_tail = read_journal(self.path)
        report.replayed_records = len(records)
        order: list = []
        st: dict = {}
        last_t = None
        for rec in records:
            t = rec.get("t")
            if t is not None and (last_t is None or t > last_t):
                last_t = t
            kind = rec.get("k")
            if kind == "submit":
                rid = rec["rid"]
                if rid in st:
                    continue  # idempotent: duplicate submit
                order.append(rid)
                st[rid] = {
                    "sub": rec, "tokens": [], "ftt": None, "faults": 0,
                    "retry_at": 0.0, "inflight": False, "fin": None,
                }
            elif kind == "delta":
                s = st.get(rec["rid"])
                if s is None:
                    continue
                cur = s["tokens"]
                if rec["tot"] <= len(cur):
                    continue  # idempotent: duplicate/stale delta
                if rec["tot"] == len(cur) + len(rec["tok"]):
                    cur.extend(rec["tok"])
                    if rec.get("ftt") is not None:
                        s["ftt"] = rec["ftt"]
                # a gap (tot > base + len) cannot occur under suffix-only
                # loss; treat it as corrupt and keep the shorter stream
            elif kind == "tr":
                s = st.get(rec["rid"])
                if s is None:
                    continue
                s["faults"] = rec.get("f", 0)
                s["retry_at"] = rec.get("ra", 0.0)
                if rec.get("st") in _INFLIGHT_STATES:
                    s["inflight"] = True
            elif kind == "fin":
                s = st.get(rec["rid"])
                if s is not None and s["fin"] is None:
                    s["fin"] = rec  # idempotent: first finish wins
        now = core.engine.clock()
        report.clock_shift = shift = now - (last_t if last_t is not None
                                            else now)
        tr = core.obs.tracer
        waiting: list = []
        inflight: list = []
        max_rid = -1
        for rid in order:
            s = st[rid]
            max_rid = max(max_rid, rid)
            if s["fin"] is not None:
                report.skipped_finished += 1
                continue
            if rid in core.requests:
                report.skipped_present += 1
                continue
            sub = s["sub"]
            prompt = np.asarray(sub["prompt"], np.int32)
            sampling = SamplingParams(
                max_new_tokens=sub["mx"],
                stop_token_ids=tuple(sub["stop"]),
                deadline_s=sub["dl"],
            )
            probe = Request(
                prompt=prompt, max_new_tokens=sampling.max_new_tokens,
                request_id=rid,
            )
            if not core.engine.request_fits(probe):
                report.skipped_unfit += 1
                continue
            cr = EngineRequest(
                prompt=prompt, sampling=sampling,
                priority=Priority(sub["pri"]), request_id=rid,
                arrival_time=sub["arr"] + shift,
                output_tokens=list(s["tokens"]),
                first_token_time=(
                    None if s["ftt"] is None else s["ftt"] + shift
                ),
                faults=s["faults"],
                retry_at=(
                    s["retry_at"] + shift if s["retry_at"] > 0.0 else 0.0
                ),
            )
            # the pre-crash incarnation already streamed these tokens (and
            # its TTFT); don't re-report them as fresh
            cr._ttft_reported = cr.first_token_time is not None
            report.replayed_tokens += len(cr.output_tokens)
            self._known.add(rid)
            self._last_tot[rid] = len(cr.output_tokens)
            tr.transition(
                rid, None, "waiting", cr.arrival_time,
                priority=cr.priority.value,
            )
            tr.instant(
                "arrival_restamp", now, request_id=rid,
                old=sub["arr"], new=cr.arrival_time,
            )
            if s["inflight"]:
                cr.state = RequestState.PREEMPTED
                tr.transition(
                    rid, "waiting", "preempted", now,
                    priority=cr.priority.value,
                )
                inflight.append(cr)
            else:
                waiting.append(cr)
            self._last_sig[rid] = (cr.state.value, cr.faults, cr.retry_at)
            core.requests[rid] = cr
        for cr in waiting:
            core.waiting[cr.priority].append(cr)
        # front of class, original relative order preserved
        for cr in reversed(inflight):
            core.waiting[cr.priority].appendleft(cr)
        for rid in self._finishes_of(st):
            self._finished.add(rid)
            self._known.add(rid)
        if max_rid >= 0:
            # future auto-assigned ids must not collide with replayed ones
            advance_request_ids(max_rid + 1)
        report.requeued_waiting = len(waiting)
        report.resumed_inflight = len(inflight)
        report.duration_s = time.monotonic() - t_wall
        m = self.metrics if self.metrics is not None else core.obs.metrics
        m.counter("recovery/restores").inc()
        m.counter("recovery/replayed_tokens").inc(report.replayed_tokens)
        m.counter("recovery/requeued_waiting").inc(report.requeued_waiting)
        m.counter("recovery/resumed_inflight").inc(report.resumed_inflight)
        m.counter("recovery/skipped_finished").inc(report.skipped_finished)
        if report.torn_tail:
            m.counter("recovery/torn_tail").inc(report.torn_tail)
        m.gauge("recovery/duration_s").set(report.duration_s)
        tr.span(
            "recovery", "control", now, now,
            requests=report.restored, tokens=report.replayed_tokens,
            skipped_finished=report.skipped_finished,
            clock_shift=shift, wall_s=report.duration_s,
        )
        return report

    @staticmethod
    def _finishes_of(st: dict) -> list:
        return [rid for rid, s in st.items() if s["fin"] is not None]
