"""Draft-model proposer: the existing device-resident speculative path,
refactored behind the ``Proposer`` interface.

The draft model lives on the device and its proposals never touch the
host: the fused ``spec.loop.spec_decode_loop`` interleaves propose, verify,
accept, and rollback for ``k`` rounds per dispatch with a single
device->host transfer at the end.  Splitting that loop to route proposals
through ``propose()`` would forfeit its one-transfer discipline, so this
class deliberately returns ``None`` — the engine sees ``kind == "device"``
and drives the fused loop — while still giving the routing controller a
uniform handle: the same per-slot acceptance feedback and, crucially, the
same *cost identity*.  A draft-model round costs
``1 + (gamma + 1) * draft_cost_ratio`` quantum steps (target chunk + draft
microsteps) where a host proposer's round costs ~1; the router prices both
with ``round_cost`` and SpecInF grants are metered accordingly.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.spec.proposers.base import ProposeContext, Proposer, TokenTree


class DraftModelProposer(Proposer):
    """Handle for the fused draft-model loop (``spec.loop``)."""

    kind = "device"

    def __init__(self, *, draft_cost_ratio: float = 0.25,
                 name: str = "draft"):
        self.draft_cost_ratio = draft_cost_ratio
        self.name = name

    def propose(self, ctx: ProposeContext) -> Optional[TokenTree]:
        # Device-resident: proposals happen inside the fused loop.
        return None
