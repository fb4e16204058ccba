"""Pluggable speculation proposers, plain-Python copies of
``repro.spec.proposers`` (DESIGN.md §10).

A ``Proposer`` turns per-slot context into a packed candidate token tree;
``spec.tree`` verifies the tree in one fused pass; ``ProposerRouter``
picks the proposer per slot per quantum from acceptance EWMAs, priced in
quantum steps so SpecInF grants stay honest.

Implementations:
  * ``DraftModelProposer``  -- the device-resident draft model (the fused
    ``spec.loop`` path behind the interface)
  * ``NgramProposer``       -- prompt-lookup over the slot's own history,
    zero model cost
  * ``StaticSuffixProposer``-- corpus-indexed continuations for
    prefix-heavy offline traffic
"""
from repro_torch.spec.proposers.base import Proposer, ProposeContext, TokenTree
from repro_torch.spec.proposers.draft import DraftModelProposer
from repro_torch.spec.proposers.ngram import NgramProposer
from repro_torch.spec.proposers.router import ProposerRouter
from repro_torch.spec.proposers.suffix import StaticSuffixProposer

__all__ = [
    "Proposer",
    "ProposeContext",
    "TokenTree",
    "DraftModelProposer",
    "NgramProposer",
    "StaticSuffixProposer",
    "ProposerRouter",
]
