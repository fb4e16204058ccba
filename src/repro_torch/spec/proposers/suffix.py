"""Static-suffix proposer: precomputed continuations for prefix-heavy
offline traffic.

Offline batches in SpecInF's bubble-filling regime often share templated
structure — evaluation harnesses, classification prompts, bulk rewrites —
where whole suffixes repeat across requests.  This proposer is built once
from a reference corpus (token sequences seen before, e.g. completed
requests of the same job): it indexes every ``order``-gram to the tokens
that followed its FIRST corpus occurrence (first wins, so the table is
deterministic regardless of corpus iteration order), then proposes that
continuation whenever a slot's trailing tokens hit the table.

Unlike ``NgramProposer`` it never scans the slot's own history — lookup is
O(1) per slot per round — making it the cheapest possible proposer for
traffic its corpus covers, and useless outside it (the router learns which
is which from acceptance feedback).
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.spec.proposers.base import ProposeContext, Proposer, TokenTree
from repro_torch.spec.tree import linear_chain


class StaticSuffixProposer(Proposer):
    """Table-driven suffix completion from a reference corpus."""

    kind = "host"

    def __init__(
        self,
        corpus: Iterable[Sequence[int]],
        *,
        order: int = 2,
        max_continuation: int = 16,
        name: str = "suffix",
    ):
        assert order >= 1
        self.order = order
        self.name = name
        self._table: dict = {}
        for seq in corpus:
            seq = list(seq)
            for s in range(len(seq) - order):
                key = tuple(seq[s:s + order])
                if key in self._table:  # first occurrence wins
                    continue
                cont = seq[s + order:s + order + max_continuation]
                if cont:
                    self._table[key] = cont

    def propose(self, ctx: ProposeContext) -> Optional[TokenTree]:
        gamma = ctx.gamma
        b = len(ctx.histories)
        tail = np.zeros((b, gamma), np.int32)
        matched = np.zeros((b,), bool)
        for i, hist in enumerate(ctx.histories):
            if not ctx.active[i] or len(hist) < self.order:
                continue
            cont = self._table.get(tuple(hist[-self.order:]))
            if not cont:
                continue
            matched[i] = True
            row = list(cont[:gamma])
            while len(row) < gamma:
                row.append(row[-1])
            tail[i] = row
        if not matched.any():
            return None
        return TokenTree(
            parents=linear_chain(gamma), tail=tail, matched=matched
        )
