"""Per-slot state rewind past rejected draft tokens (counterpart of
``repro.spec.rollback``).

* KV caches need only the index rewind the loop performs: a rejected
  position's K/V sits at ``pos >= index`` after the rewind and is rewritten
  before it is ever attended to.  No data moves.
* Recurrent state (the Mamba1 family) is consumed by every step: the
  reference's chunk pass captures the state after each step, and acceptance
  selects, per slot, the state after ``accepted + 1`` tokens
  (``select_step_state``).  Speculation on a recurrent target or draft is
  not ported yet; the engine refuses it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig


def rollback_recurrent(
    cfg: ModelConfig,
    step_states: Optional[dict],
    sel: torch.Tensor,
    active: torch.Tensor,
    old_states: Optional[dict],
) -> Optional[dict]:
    """Each active slot's post-acceptance recurrent state; frozen slots keep
    their pre-round state.  The attention families have none (``step_states`` is
    ``None``): the rollback is the index rewind, and ``old_states`` comes
    back unchanged.  Recurrent-state selection is not ported yet."""
    if step_states is None:
        return old_states
    raise NotImplementedError(
        f"recurrent-state rollback ({cfg.family!r}) is not ported yet"
    )
