"""Per-slot state rewind past rejected draft tokens (counterpart of
``repro.spec.rollback``).

* KV caches need only the index rewind the loop performs: a rejected
  position's K/V sits at ``pos >= index`` after the rewind and is rewritten
  before it is ever attended to.  No data moves.
* Recurrent state (Mamba1's conv and SSM state, the hybrid's Mamba2 state)
  is consumed by every step: the chunk pass and the draft capture the state
  after each step (a leading step axis), and acceptance selects, per slot,
  the state after ``accepted + 1`` consumed tokens (``select_step_state``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map


def select_step_state(
    stacked: torch.Tensor, sel: torch.Tensor, batch_axis: int
) -> torch.Tensor:
    """Per-slot gather along the leading step axis.  stacked: [steps, ...]
    with the batch dimension at ``batch_axis`` (counting the step axis);
    sel: [B] int step index per slot.  Returns the selected state without
    the step axis (the batch at ``batch_axis - 1``)."""
    lb = torch.movedim(stacked, batch_axis, 0)  # [B, steps, ...]
    out = lb[torch.arange(lb.shape[0], device=lb.device), sel.long()]  # [B, ...]
    return torch.movedim(out, 0, batch_axis - 1)


def rollback_recurrent(
    cfg: ModelConfig,
    step_states: Optional[dict],
    sel: torch.Tensor,
    active: torch.Tensor,
    old_states: Optional[dict],
) -> Optional[dict]:
    """Each active slot's post-acceptance recurrent state; frozen slots keep
    their pre-round state.  step_states: the per-step stack of
    ``decode_chunk`` / ``draft_propose`` (``None`` for the attention
    families: the rollback is the index rewind, and ``old_states`` comes
    back unchanged); sel: [B] accepted counts (the state after ``sel + 1``
    consumed tokens is step ``sel``); active: [B] bool; old_states: the
    pre-round state, for the frozen slots.  Returns new tensors."""
    if step_states is None:
        return old_states
    ba = T.recurrent_state_batch_axis(cfg) + 1  # +1 for the step axis

    def pick(stacked, old):
        picked = select_step_state(stacked, sel, ba)
        shape = [1] * picked.ndim
        shape[ba - 1] = picked.shape[ba - 1]
        return torch.where(active.reshape(shape), picked, old)

    return tree_map(pick, step_states, old_states)
