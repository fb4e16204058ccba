"""Adaptive draft length (gamma), a plain-Python copy of
``repro.spec.controller``.

Algorithm 1 decides when inference may run and how many tokens a grant is
worth; this controller decides how speculative each round is:

* the phase gates the appetite: a conservative grant keeps the smallest
  gamma (training is about to resume), incremental allows the lower half of
  the buckets, stable all of them;
* the observed acceptance p (an EWMA over verify outcomes) picks the bucket
  with the most expected verified tokens per unit cost:
  ``E[tokens] = (1 - p^(g+1)) / (1 - p)`` for a round costing
  ``1 + (g + 1) * draft_cost_ratio`` target-step equivalents.
"""
from __future__ import annotations

#: Draft lengths the engine runs (chunk = gamma + 1 target positions).
GAMMA_BUCKETS = (1, 2, 4)


class AdaptiveGammaController:
    def __init__(
        self,
        buckets: tuple[int, ...] = GAMMA_BUCKETS,
        *,
        ewma: float = 0.5,
        draft_cost_ratio: float = 0.25,
        init_acceptance: float = 0.7,
    ):
        assert buckets == tuple(sorted(buckets)) and buckets[0] >= 1
        assert 0.0 < ewma <= 1.0
        self.buckets = tuple(buckets)
        self.ewma = ewma
        self.draft_cost_ratio = draft_cost_ratio
        self.acceptance = init_acceptance

    @classmethod
    def from_spec(cls, spec) -> "AdaptiveGammaController":
        """The controller a ``SpecDecodeConfig`` describes."""
        return cls(spec.gamma_buckets, ewma=spec.accept_ewma,
                   draft_cost_ratio=spec.draft_cost_ratio)

    def observe(self, accepted: int, proposed: int) -> None:
        """Fold one loop's verify outcome into the acceptance EWMA."""
        if proposed > 0:
            rate = accepted / proposed
            self.acceptance += self.ewma * (rate - self.acceptance)

    def expected_tokens_per_round(self, gamma: int) -> float:
        """E[verified tokens] of one round at the current acceptance."""
        p = min(max(self.acceptance, 0.0), 0.99)
        if p == 0.0:
            return 1.0
        return (1.0 - p ** (gamma + 1)) / (1.0 - p)

    def round_cost_steps(self, gamma: int) -> float:
        """Round cost in target-step equivalents (chunk verify + drafts)."""
        return 1.0 + (gamma + 1) * self.draft_cost_ratio

    def gamma_for(self, phase) -> int:
        """Draft length of the next loop: the phase-gated argmax of expected
        tokens per cost.  ``phase`` is a ``core.scheduler.Phase`` or its
        value string."""
        name = getattr(phase, "value", phase)
        if name == "conservative":
            allowed = self.buckets[:1]
        elif name == "incremental":
            allowed = self.buckets[: max(1, (len(self.buckets) + 1) // 2)]
        else:
            allowed = self.buckets
        return max(
            allowed,
            key=lambda g: self.expected_tokens_per_round(g)
            / self.round_cost_steps(g),
        )
