"""N-gram / prompt-lookup proposer: zero-model-cost candidates from the
slot's own context.

Prompt-heavy workloads (summarization, code editing, RAG) repeat long
spans of their own input; a draft *model* is overkill for them.  This
proposer matches the slot's most recent ``order`` tokens against its full
history — prompt plus everything accepted so far, which the engine already
keeps host-side for the radix prefix cache — and proposes the tokens that
followed the most recent earlier occurrence.  ``width > 1`` proposes up to
``width`` branches from distinct earlier occurrences (most recent first),
packed as sibling chains under the shared root.

Wholly deterministic: proposals are a pure function of the histories (the
property a unit test pins down).  When NO active slot has a match the
proposer returns ``None`` and the engine falls back to plain (non-spec)
decode for the quantum instead of paying a doomed verify pass.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.spec.proposers.base import ProposeContext, Proposer, TokenTree
from repro_torch.spec.tree import branching_tree, linear_chain


def _find_continuations(hist, order: int, gamma: int, width: int):
    """All distinct ``gamma``-token continuations of the trailing
    ``order``-gram, most recent occurrence first.  Pure + deterministic."""
    n = len(hist)
    if n < order + 1:
        return []
    key = tuple(hist[n - order:])
    outs: list = []
    seen = set()
    # scan candidate match positions right-to-left, excluding the trailing
    # occurrence itself
    for start in range(n - order - 1, -1, -1):
        if tuple(hist[start:start + order]) != key:
            continue
        cont = list(hist[start + order:start + order + gamma])
        if not cont:
            continue
        while len(cont) < gamma:  # short tail: repeat the last token
            cont.append(cont[-1])
        t = tuple(cont)
        if t in seen:
            continue
        seen.add(t)
        outs.append(cont)
        if len(outs) >= width:
            break
    return outs


class NgramProposer(Proposer):
    """Prompt-lookup decoding over the slot's prompt + generated history."""

    kind = "host"

    def __init__(self, *, order: int = 3, name: str = "ngram"):
        assert order >= 1
        self.order = order
        self.name = name

    def propose(self, ctx: ProposeContext) -> Optional[TokenTree]:
        gamma, width = ctx.gamma, max(1, ctx.width)
        b = len(ctx.histories)
        n_tail = width * gamma
        tail = np.zeros((b, n_tail), np.int32)
        matched = np.zeros((b,), bool)
        for i, hist in enumerate(ctx.histories):
            if not ctx.active[i]:
                continue
            conts = _find_continuations(hist, self.order, gamma, width)
            if not conts:
                continue
            matched[i] = True
            for w, cont in enumerate(conts):
                tail[i, w * gamma:(w + 1) * gamma] = cont
            for w in range(len(conts), width):  # pad branches: repeat first
                tail[i, w * gamma:(w + 1) * gamma] = conts[0]
        if not matched.any():
            return None
        parents = (
            linear_chain(gamma) if width == 1 else branching_tree(width, gamma)
        )
        return TokenTree(parents=parents, tail=tail, matched=matched)
