"""Failure containment, graceful degradation and crash durability (own
copy of ``repro.resilience``), all host-side and deterministic on a virtual
clock.

* ``faults`` -- the seeded fault injector.  Its named points, each drawing
  from its own stream (``crc32(point) ^ seed``):

  ========================== ===============================================
  ``engine/nan_logits``      the engine poisons one decodable slot's last
                             written K (layer 0, in place) before a fused
                             dispatch: that slot's logits turn NaN and the
                             slot is quarantined, scrubbed and retried
  ``pool/alloc_fail``        ``PagePool.alloc`` raises ``PageAllocError``:
                             admission blocks, a top-up evicts and
                             re-queues the one slot
  ``core/revoke_mid_quantum`` ``EngineCore.step`` revokes its grant
                             between decode sub-dispatches
  ``core/step_overrun``      a quantum costs 25-75 % more than priced
  ``runtime/early_resume``   ``SpecInFRuntime`` arms the bubble's
                             revocation at a seeded 25-75 % of its span
  ``process/kill``           ``EngineCore.step`` raises ``ProcessKilled``
                             between quanta or mid-quantum; recovery
                             replays the journal
  ========================== ===============================================

* ``degradation`` -- the hysteretic overload ladder ``EngineCore`` consults
  each quantum (spec off -> k shrink -> offline shedding -> online
  deadline shedding);
* ``journal`` / ``snapshot`` -- the write-ahead request journal with
  deterministic replay recovery, and the optional radix-cache snapshot
  through ``repro_torch.checkpoint.Checkpointer``.

The containment itself lives where the faults land: the per-slot NaN
screens and ``PageAllocError`` handling in ``serving/engine.py``, revocable
grants and the retry budget in ``serving/core.py``, early resume in
``core/filling.py``.
"""
from repro_torch.resilience.degradation import (  # noqa: F401
    LadderConfig,
    LadderStage,
    OverloadLadder,
)
from repro_torch.resilience.faults import (  # noqa: F401
    FAULT_POINTS,
    FaultInjector,
    FaultSpec,
    ProcessKilled,
)
from repro_torch.resilience.journal import (  # noqa: F401
    RecoveryReport,
    RequestJournal,
    read_journal,
)
from repro_torch.resilience.snapshot import EngineSnapshot  # noqa: F401

__all__ = [
    "FAULT_POINTS",
    "EngineSnapshot",
    "FaultInjector",
    "FaultSpec",
    "LadderConfig",
    "LadderStage",
    "OverloadLadder",
    "ProcessKilled",
    "RecoveryReport",
    "RequestJournal",
    "read_journal",
]
