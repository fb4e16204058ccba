"""Deterministic, seeded fault injection (own copy of
``repro.resilience.faults``).

A ``FaultInjector`` is a passive oracle the serving stack consults at
named *fault points*; it never touches engine state itself.  Each point
draws from its own ``numpy`` Generator seeded from
``crc32(point) ^ seed``, so

* a chaos run is reproducible from its seed alone (the virtual clock
  makes the schedule deterministic, the injector makes the faults so);
* points are independent — adding a new fault point, or changing how
  often one is consulted, never perturbs another point's draw sequence.

Fault points wired into the stack:

========================  =================================================
``engine/nan_logits``     poison one active slot's KV before a fused
                          dispatch -> NaN logits for that slot
``pool/alloc_fail``       ``PagePool.alloc`` raises ``PageAllocError``
                          (transient allocator failure, distinct from
                          genuine pool exhaustion)
``core/revoke_mid_quantum``  revoke the grant mid-``EngineCore.step()``
``core/step_overrun``     inflate a quantum's step cost (slow-step fault)
``runtime/early_resume``  training resumes before the predicted bubble
                          end; the runtime arms the grants' revocation
``process/kill``          sever the engine process: ``EngineCore.step()``
                          raises ``ProcessKilled`` between quanta or
                          mid-quantum (after device work, before the
                          journal append) — recovery replays the
                          write-ahead journal (DESIGN.md §11)
========================  =================================================

Use ``FaultSpec`` to arm a point::

    inj = FaultInjector(seed=7, specs=[
        FaultSpec("engine/nan_logits", probability=0.2, max_fires=3),
    ])
    if inj.should_fire("engine/nan_logits"):
        ...

Unarmed points never fire, so a default-constructed injector is inert.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np

__all__ = ["FaultInjector", "FaultSpec", "FAULT_POINTS", "ProcessKilled"]

#: the named fault points the serving stack consults (documentation +
#: validation surface; ``FaultSpec`` for an unknown point is an error)
FAULT_POINTS = (
    "engine/nan_logits",
    "pool/alloc_fail",
    "core/revoke_mid_quantum",
    "core/step_overrun",
    "runtime/early_resume",
    "process/kill",
)


class ProcessKilled(RuntimeError):
    """Simulated process death (the ``process/kill`` fault point).

    Raised out of ``EngineCore.step()``; the in-memory engine/core pair is
    unusable afterwards and must be abandoned.  Chaos harnesses catch it,
    truncate the request journal to its fsynced prefix
    (``RequestJournal.crash``), and rebuild a fresh engine via
    ``RequestJournal.recover_into`` (DESIGN.md §11)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Arming description for one fault point.

    ``probability`` is the per-consultation fire chance; ``after`` skips
    the first N consultations (lets a workload warm up before chaos);
    ``max_fires`` caps total fires (None = unbounded)."""

    point: str
    probability: float = 1.0
    after: int = 0
    max_fires: Optional[int] = None

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; known: {FAULT_POINTS}"
            )


class FaultInjector:
    """Seeded fault oracle.  One instance per chaos run; thread-unsafe by
    design (the serving stack is single-threaded per engine)."""

    def __init__(self, seed: int = 0, specs: tuple = ()):  # noqa: D401
        self.seed = int(seed)
        self.specs = {s.point: s for s in specs}
        self._rngs: dict = {}
        self.consults: dict = {p: 0 for p in self.specs}
        self.fires: dict = {p: 0 for p in self.specs}
        #: optional metrics registry; set by whoever wires the injector in
        #: so every fire lands on the ``fault/injected`` counter
        self.metrics = None

    def _rng(self, point: str) -> np.random.Generator:
        rng = self._rngs.get(point)
        if rng is None:
            # crc32 keys the stream by point name: stable across runs and
            # processes (unlike hash()), independent across points
            rng = np.random.default_rng(
                zlib.crc32(point.encode()) ^ (self.seed & 0xFFFFFFFF)
            )
            self._rngs[point] = rng
        return rng

    def should_fire(self, point: str) -> bool:
        """Consult ``point``: True when the armed spec fires this draw."""
        spec = self.specs.get(point)
        if spec is None:
            return False
        n = self.consults[point]
        self.consults[point] = n + 1
        # the draw happens on EVERY consultation, armed or not past its
        # cap, so max_fires/after never shift later draws in the stream
        hit = self._rng(point).random() < spec.probability
        if n < spec.after:
            return False
        if spec.max_fires is not None and self.fires[point] >= spec.max_fires:
            return False
        if hit:
            self.fires[point] += 1
            if self.metrics is not None:
                self.metrics.counter("fault/injected").inc()
        return hit

    def uniform(self, point: str) -> float:
        """An extra U[0,1) draw from ``point``'s stream (fault shaping:
        e.g. where inside the bubble training resumes)."""
        return float(self._rng(point).random())

    def choice(self, point: str, n: int) -> int:
        """An extra integer draw in [0, n) from ``point``'s stream."""
        return int(self._rng(point).integers(n))

    @property
    def total_fires(self) -> int:
        return sum(self.fires.values())
