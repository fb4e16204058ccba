"""Adaptive proposer routing: pick the cheapest candidate source per slot
per quantum from acceptance feedback.

Different slots want different proposers — a summarization request feeds
the n-gram proposer perfectly while a cold chat turn needs the draft
model — and the right choice shifts over a request's lifetime.  The router
keeps a per-(slot, proposer) acceptance-rate EWMA (seeded optimistically so
every proposer gets tried before being written off) and each quantum ranks
proposers by *expected verified tokens per quantum step*:

    score = E[tokens/round](p_hat, gamma) / round_cost(proposer, gamma)

using the same geometric-series expectation as the gamma controller
(``spec.controller``).  The cost side is what makes routing GRANT-AWARE:
a draft-model round spends ``1 + (gamma + 1) * draft_cost_ratio`` steps of
a SpecInF bubble grant (target chunk + draft microsteps), while a
model-free host proposal spends ~1 (the verify chunk alone).  SpecInF's
policy layer reads ``round_cost`` for the routed choice when converting
granted steps into rounds, so Algorithm-1 grants are priced by what will
actually run.
"""
from __future__ import annotations

from typing import Optional, Sequence


class ProposerRouter:
    """Per-slot acceptance-EWMA routing over registered proposers."""

    def __init__(
        self,
        names: Sequence[str],
        *,
        device_names: Sequence[str] = ("draft",),
        ewma: float = 0.5,
        init_acceptance: float = 0.7,
        draft_cost_ratio: float = 0.25,
        host_round_cost: float = 1.0,
    ):
        assert names, "router needs at least one proposer"
        self.names = tuple(names)
        self.device_names = frozenset(device_names)
        self.ewma = ewma
        self.init_acceptance = init_acceptance
        self.draft_cost_ratio = draft_cost_ratio
        self.host_round_cost = host_round_cost
        self._acc: dict = {}  # (slot, name) -> EWMA acceptance rate
        self._last_pick: dict = {}  # slot -> name
        self.switches = 0  # slot-level routing changes (observability)

    # -- feedback -------------------------------------------------------
    def acceptance(self, slot: int, name: str) -> float:
        return self._acc.get((slot, name), self.init_acceptance)

    def observe(self, slot: int, name: str, accepted: int,
                proposed: int) -> None:
        """Fold one verified round's outcome into the (slot, name) EWMA.
        ``accepted`` is the unclamped run (budget cuts are not proposer
        rejections — same rule as the gamma controller)."""
        if proposed <= 0:
            return
        rate = min(accepted / proposed, 1.0)
        prev = self.acceptance(slot, name)
        self._acc[(slot, name)] = (
            self.ewma * rate + (1.0 - self.ewma) * prev
        )

    def reset_slot(self, slot: int) -> None:
        """Forget a slot's history (the engine calls this on retire/evict
        so a recycled slot starts optimistic again)."""
        for name in self.names:
            self._acc.pop((slot, name), None)
        self._last_pick.pop(slot, None)

    # -- pricing --------------------------------------------------------
    @staticmethod
    def expected_tokens_per_round(p: float, gamma: int) -> float:
        """Geometric-series expectation, same model as the gamma
        controller: sum_{i=0..gamma} p^i."""
        p = min(max(p, 0.0), 0.99)
        return (1.0 - p ** (gamma + 1)) / (1.0 - p)

    def round_cost(self, name: str, gamma: int) -> float:
        """Quantum steps one round spends: target chunk (1) plus, for the
        device-resident draft model, its gamma+1 microsteps at the
        profiled draft/target cost ratio.  Host proposals are model-free."""
        if name in self.device_names:
            return 1.0 + (gamma + 1) * self.draft_cost_ratio
        return self.host_round_cost

    def score(self, slot: int, name: str, gamma: int) -> float:
        p = self.acceptance(slot, name)
        return self.expected_tokens_per_round(p, gamma) / self.round_cost(
            name, gamma
        )

    # -- selection ------------------------------------------------------
    def pick(self, slot: int, gamma: int,
             available: Optional[Sequence[str]] = None) -> str:
        """Best-scoring proposer for the slot (ties break toward the
        registration order).  ``available`` restricts the choice set (e.g.
        host proposers are gated off for recurrent families)."""
        pool = [n for n in self.names
                if available is None or n in available]
        assert pool, "no proposer available to route"
        best = max(pool, key=lambda n: (self.score(slot, n, gamma),
                                        -pool.index(n)))
        if self._last_pick.get(slot) not in (None, best):
            self.switches += 1
        self._last_pick[slot] = best
        return best

    def pick_majority(self, slots: Sequence[int], gamma: int,
                      available: Optional[Sequence[str]] = None) -> str:
        """One proposer for a whole batch quantum: the highest summed score
        across the given slots.  The engine dispatches one fused program
        per quantum, so routing is per-slot in *state* but per-quantum in
        *choice*."""
        pool = [n for n in self.names
                if available is None or n in available]
        assert pool, "no proposer available to route"
        if not slots:
            return pool[0]
        totals = {
            n: sum(self.score(s, n, gamma) for s in slots) for n in pool
        }
        best = max(pool, key=lambda n: (totals[n], -pool.index(n)))
        for s in slots:
            if self._last_pick.get(s) not in (None, best):
                self.switches += 1
            self._last_pick[s] = best
        return best
