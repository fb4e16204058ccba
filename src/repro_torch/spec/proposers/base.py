"""The ``Proposer`` interface: pluggable candidate sources for speculative
verification.

A proposer turns per-slot context into a packed candidate token tree
(``spec.tree``) that the target model verifies in one fused pass.  Two
kinds exist:

  * ``host`` — the proposal is computed on the host from the slot's token
    history at zero model cost (n-gram lookup, static suffixes).  The
    engine drives these through ``tree_verify_round``: one dispatch and one
    device->host transfer per round, because the proposer must see the
    accepted tokens before proposing again.
  * ``device`` — the proposal is a draft *model* resident on the device;
    ``propose`` returns ``None`` and the engine runs the fused
    ``spec_decode_loop`` instead (k rounds per dispatch).  The proposer
    object still exists so the routing controller treats every candidate
    source uniformly — same acceptance feedback, same cost accounting.

``observe`` closes the loop: after each verified round the engine reports
(accepted, proposed) per slot, feeding both the proposer's own adaptation
(if any) and the router's per-slot acceptance EWMA.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenTree:
    """A packed candidate tree (see ``spec.tree`` for the layout).

    ``parents``: static topology including the root (``parents[0] == -1``,
    parents precede children); shared across the batch.  ``tail``: [B, N-1]
    int32 candidate tokens for nodes 1..N-1 (node 0 is the slot's current
    token, supplied by the engine).  ``matched``: [B] bool, True where the
    proposer found real evidence for the slot (False rows carry filler the
    verifier will reject — they still emit one target token per round)."""

    parents: tuple
    tail: np.ndarray
    matched: np.ndarray


@dataclasses.dataclass
class ProposeContext:
    """Per-quantum proposal input.

    ``histories``: one int list per slot — prompt + accepted tokens so far
    (the engine maintains these host-side; empty list = empty slot).
    ``active``: [B] bool slots that will decode this round.  ``gamma``:
    requested candidate depth.  ``width``: requested branch count (1 =
    linear chain)."""

    histories: Sequence[Sequence[int]]
    active: np.ndarray
    gamma: int
    width: int = 1


class Proposer:
    """Base class; subclasses set ``name``/``kind`` and implement
    ``propose``."""

    name: str = "base"
    kind: str = "host"  # "host" | "device"

    def propose(self, ctx: ProposeContext) -> Optional[TokenTree]:
        """Return a candidate tree, or ``None`` when this proposer has
        nothing to offer this round (no slot matched — the engine falls
        back to plain decode) or is device-resident."""
        raise NotImplementedError

    def observe(self, slot: int, accepted: int, proposed: int) -> None:
        """Per-slot acceptance feedback after verification (default: no
        per-proposer state; the router keeps the EWMA)."""
