"""Speculative decoding: draft-propose / target-verify (counterpart of
``repro.spec``).

A cheap draft model proposes ``gamma`` tokens per slot, the target scores
all ``gamma + 1`` chunk positions in ONE pass (the paged chunk-verify
kernel), and acceptance keeps the longest target-consistent prefix, rolling
each slot's cache index back past rejected tokens.  Host-side proposers
(n-gram, static suffix) instead hand the target a packed candidate tree,
verified in one pass by the paged tree-verify kernel.

Modules:
  * ``draft``      -- draft-model proposer (greedy / seeded sampling)
  * ``verify``     -- acceptance rules: greedy, sampled (residual), simulated
  * ``rollback``   -- per-slot state rewind past rejected tokens
  * ``loop``       -- ``spec_round`` and the k-round ``spec_decode_loop``
  * ``controller`` -- adaptive gamma from the Algorithm-1 phase + acceptance
  * ``tree``       -- packed-tree verification and KV path compaction
  * ``proposers``  -- pluggable candidate sources + the acceptance router

Random draws come from an explicit ``torch.Generator``; every random rule
also has a ``*_with`` form that takes its draws as tensors.
"""
from repro_torch.spec.controller import GAMMA_BUCKETS, AdaptiveGammaController
from repro_torch.spec.draft import draft_propose
from repro_torch.spec.loop import spec_decode_loop, spec_round
from repro_torch.spec.tree import (
    branching_tree,
    linear_chain,
    tree_greedy_accept,
    tree_verify_round,
)
from repro_torch.spec.verify import greedy_accept, sampled_accept, simulated_accept

__all__ = [
    "GAMMA_BUCKETS",
    "AdaptiveGammaController",
    "draft_propose",
    "spec_decode_loop",
    "spec_round",
    "greedy_accept",
    "sampled_accept",
    "simulated_accept",
    "branching_tree",
    "linear_chain",
    "tree_greedy_accept",
    "tree_verify_round",
]
