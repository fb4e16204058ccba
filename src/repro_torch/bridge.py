"""Weight bridge: the reference's parameter tree (as numpy) -> the port's.

The port keeps the reference pytree's names and layouts (stacked ``[L, ...]``
layers, ``wq [d, H, hd]``, ``wo [H, hd, d]``), so the bridge is a plain copy
of every leaf.  The caller hands it a nested dict of numpy arrays (the tests
build one with ``jax.tree.map(np.asarray, T.init_params(...))``); the bridge
itself never sees JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, *, device: str | torch.device = "cuda") -> Any:
    """Copy a nested dict of numpy arrays into torch tensors on ``device``,
    keeping every key, shape and dtype."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)
