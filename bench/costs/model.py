"""Operations and bytes of the dense decoder's work, from its shapes alone
(the config file's ``model`` block).  Frozen here so that no later change to
the program moves the yardstick.

Operations count each multiply-add of a product as 2.  The model's matrix
products per token are the projections and the MLP of every layer and the
head (a tied table counted once, as the head; the embedding lookup is a
gather, not a product).  Causal attention adds 4 * heads * head_dim
operations per visible (query, key) pair and layer (QK^T and PV); training
triples the forward's operations (the backward's two products per product)
and counts no recompute.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet: dense bfloat16 tensor-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def layer_matmul_params(m: dict) -> int:
    d, h, kv, hd, ff = (m[k] for k in ("d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff"))
    return d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff


def matmul_params(m: dict) -> int:
    """Weights a token multiplies: every layer's products and the head."""
    return m["num_layers"] * layer_matmul_params(m) + m["d_model"] * m["vocab_size"]


def attention_ops(m: dict, pairs: int) -> float:
    """QK^T and PV over ``pairs`` visible (query, key) pairs, every layer."""
    return 4.0 * m["num_heads"] * m["head_dim"] * pairs * m["num_layers"]


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    """One training step on ``batch`` rows of ``seq`` tokens, causal."""
    tokens = batch * seq
    pairs = batch * seq * (seq + 1) // 2
    return 3.0 * (2.0 * matmul_params(m) * tokens + attention_ops(m, pairs))


def tokens_flops(m: dict, tokens: int, pairs: int) -> float:
    """A serving pass over ``tokens`` new tokens that see ``pairs``
    (query, key) pairs in all."""
    return 2.0 * matmul_params(m) * tokens + attention_ops(m, pairs)


def kv_bytes_per_token(m: dict, itemsize: int = 2) -> int:
    return m["num_layers"] * 2 * m["num_kv_heads"] * m["head_dim"] * itemsize


def weight_bytes(m: dict, itemsize: int = 2) -> int:
    """Bytes of the served matrices, each read once a pass (the tied table
    once, as the head); norm weights are negligible and left out."""
    return matmul_params(m) * itemsize


def decode_step_bound_s(m: dict, lengths: list, itemsize: int = 2) -> float:
    """Least time of one decode microstep of the slots whose caches hold
    ``lengths`` keys (the new token's included): the larger of its operations
    at the bfloat16 peak and its bytes (weights and each slot's K/V read
    once) at the HBM rate."""
    ops = tokens_flops(m, len(lengths), sum(lengths))
    nbytes = weight_bytes(m, itemsize) + kv_bytes_per_token(m, itemsize) * sum(lengths)
    return max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
