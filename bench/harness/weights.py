"""Random weights of a dense decoder, made by the benchmark from the seed.

The tree has the port's layout (``embed``, the ``[L, ...]`` stacks under
``layers``, ``final_norm``, an untied ``lm_head``), so the same tensors go to
the program and, regenerated, to the plain reference.  Each leaf is one
``torch.randn`` call on the device with a generator of its own (seeded from
the run seed and the leaf's index), so a single leaf can be made again
without the others.  Scales: a matrix is normal over the square root of its
fan-in (``wo``: of the query heads' width), norm weights are ones.
"""
from __future__ import annotations

import numpy as np
import torch


def leaves(m: dict) -> list:
    """``(path, shape, fan_in)`` of every leaf of the dense decoder ``m``
    (the config file's ``model`` block), in the port's order; ``fan_in``
    None marks a norm weight (ones)."""
    L, d, h, kv, hd, ff, v = (m[k] for k in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                                             "head_dim", "d_ff", "vocab_size"))
    out = [("embed", (v, d), d),
           ("layers/attn/wq", (L, d, h, hd), d),
           ("layers/attn/wk", (L, d, kv, hd), d),
           ("layers/attn/wv", (L, d, kv, hd), d),
           ("layers/attn/wo", (L, h, hd, d), h * hd)]
    if m.get("qk_norm"):
        out += [("layers/attn/q_norm", (L, hd), None), ("layers/attn/k_norm", (L, hd), None)]
    out += [("layers/ffn/wg", (L, d, ff), d), ("layers/ffn/wu", (L, d, ff), d),
            ("layers/ffn/wd", (L, ff, d), ff)]
    if m.get("parametric_norm", True):
        out += [("layers/ln1", (L, d), None), ("layers/ln2", (L, d), None),
                ("final_norm", (d,), None)]
    if not m.get("tie_embeddings"):
        out.append(("lm_head", (d, v), d))
    return out


def _generator(seed: int, index: int, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), 99, index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def leaf(m: dict, seed: int, index: int, device, dtype=torch.float32) -> torch.Tensor:
    """Leaf ``index`` of ``leaves(m)``: made in float32, then cast to
    ``dtype`` (so a bfloat16 leaf is the float32 leaf rounded)."""
    _, shape, fan_in = leaves(m)[index]
    if fan_in is None:
        return torch.ones(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=_generator(seed, index, device), device=device,
                    dtype=torch.float32)
    return t.mul_(fan_in ** -0.5).to(dtype)


def make(m: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The whole tree, nested by path, leaves in ``dtype``."""
    tree: dict = {}
    for i, (path, _, _) in enumerate(leaves(m)):
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf(m, seed, i, device, dtype)
    return tree


def flat(tree: dict, prefix: str = "") -> dict:
    """``{path: leaf}`` of a nested tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
