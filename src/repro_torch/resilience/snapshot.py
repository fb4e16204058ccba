"""Optional warm-state engine snapshot (own copy of
``repro.resilience.snapshot``).

``EngineSnapshot`` periodically exports the radix prefix cache — tree
structure plus the KV contents of its pages — through the
``Checkpointer`` (atomic tmp+rename, fsync'd, manifest-gated,
retention-GC'd; the KV pages in the engine's dtype, bf16 as its bit
pattern, so a restore is bit-exact), so a restarted engine recovers *prefix hits* instead of
cold re-prefilling every replayed request.

Division of labour with the request journal
(``resilience/journal.py``):

* the **journal** is the sole source of truth for request state — it is
  required for recovery and its replay is exact;
* the **snapshot** is derived KV cache only — best-effort warm state
  that is never required for correctness.  Greedy prefill is
  deterministic, so a missing/stale/partial snapshot merely costs
  re-prefill compute, never output bytes.

Journal-vs-snapshot consistency is resolved by replaying the journal
suffix: restore loads the newest snapshot whose journal watermark (the
durable byte offset at save time) does not exceed the journal's current
durable length, then ``RequestJournal.recover_into`` replays the FULL
journal on top.  A snapshot that outran the surviving journal (its tail
was lost in the crash) is discarded — its pages may encode prompts the
journal no longer knows about, and warm state must stay a strict subset
of journaled truth.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["EngineSnapshot"]


class EngineSnapshot:
    """Radix-cache snapshot/restore for one ``InferenceEngine``.

    ``checkpointer`` is a ``repro_torch.checkpoint.Checkpointer`` (typically
    rooted next to, but distinct from, the training checkpoints);
    ``journal`` (optional) stamps each snapshot with the journal's
    durable watermark for the consistency rule above."""

    def __init__(self, engine, checkpointer, journal=None):
        self.engine = engine
        self.checkpointer = checkpointer
        self.journal = journal
        self._step = 0

    @property
    def _metrics(self):
        return self.engine.obs.metrics

    # ------------------------------------------------------------------
    def save(
        self, step: Optional[int] = None, blocking: bool = True
    ) -> bool:
        """Export the current radix-cache contents; returns False when
        there is nothing to snapshot (dense engine / empty cache)."""
        exported = self.engine.export_prefix_pages()
        if exported is None:
            return False
        nodes, k, v = exported
        ps = self.engine.kv_page_size
        if step is None:
            self._step += 1
            step = self._step
        else:
            self._step = max(self._step, step)
        watermark = -1
        if self.journal is not None:
            # records past this offset were not yet durable: a crash may
            # erase them, so restore must treat this snapshot as invalid
            # if the surviving journal is shorter
            self.journal.commit()
            watermark = self.journal._synced_offset
        payload = {
            "chunks": np.asarray(
                [chunk for _, chunk, _ in nodes], np.int32
            ).reshape(len(nodes), ps),
            "parents": np.asarray([p for p, _, _ in nodes], np.int32),
            # KV in the engine's dtype (the checkpointer keeps bf16 as its
            # bit pattern): a restore is bit-exact
            "k": k,
            "v": v,
            "journal_seq": np.asarray([watermark], np.int64),
        }
        self.checkpointer.save(step, payload, blocking=blocking)
        self._metrics.counter("recovery/snapshot_saves").inc()
        return True

    # ------------------------------------------------------------------
    def restore(self, step: Optional[int] = None) -> int:
        """Warm the engine's radix cache from the newest consistent
        snapshot; returns the nodes loaded (0 when none is usable).
        Call BEFORE ``RequestJournal.recover_into`` — replay then runs
        against the warmed cache."""
        try:
            tree, found = self.checkpointer.restore(None, step)
        except FileNotFoundError:
            return 0
        watermark = int(tree["journal_seq"][0])
        if self.journal is not None and watermark >= 0:
            durable = (
                os.path.getsize(self.journal.path)
                if os.path.exists(self.journal.path) else 0
            )
            if watermark > durable:
                self._metrics.counter("recovery/snapshot_discarded").inc()
                return 0
        nodes = [
            (int(p), tuple(int(t) for t in chunk), 0)
            for p, chunk in zip(
                tree["parents"].tolist(), tree["chunks"].tolist()
            )
        ]
        loaded = self.engine.import_prefix_pages(
            nodes, tree["k"], tree["v"]
        )
        self._metrics.counter("recovery/snapshot_nodes").inc(loaded)
        self._step = max(self._step, found)
        return loaded
