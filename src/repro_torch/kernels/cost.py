"""What each kernel entry point of ``kernels/ops.py`` costs as the card
launches it: the CUDA kernels a call launches (by symbol, as a profiler
names them), the operations the function computes and the bytes it must
move, counted as ``PERF.md``'s bound column counts them -- each input read
once, each output written once, whatever a kernel reads again; scratch a
kernel keeps for itself (split partials, flash's D, the scan's
checkpoints) is the kernel's choice, not the function's, and is not
counted.  Operations are the products' multiply-adds (2 each: QK^T and PV
are 4 per visible (query, key) pair and head dim; the flash backward 10)
and, for the scan, the per-state steps its docstrings name.

Where the work depends on the data (lengths, chunk starts, a page table
shared between slots, a tree's visibility masks) a function counts what
the given tensors need; on ``meta`` tensors, which hold no values, it
counts every slot full: every key of the slot's capacity live, chunks of
C rows ending at the capacity, distinct pages.

Each function takes the arguments of the kernel wrapper it prices and
returns a ``KernelCost``.  ``bound_s`` turns one into the roofline's least
time on a ``core.hardware.HardwareSpec``: the larger of bytes over the
memory rate and operations over the peak of the products' type.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.prefill_attention import prefill_body
from repro_torch.kernels.verify_attention import dense_verify_plan, MAX_CLUSTER

#: every CUDA kernel symbol a ``KernelCost`` names (``kernels/csrc``)
SYMBOLS = (
    "paged_decode_cluster_kernel", "dense_decode_cluster_kernel", "dense_decode_partial_kernel",
    "combine_splits", "paged_prefill_tc_kernel", "paged_prefill_kernel",
    "dense_prefill_tc_kernel", "dense_prefill_kernel", "flash_fwd_tc_kernel", "flash_fwd_kernel",
    "flash_bwd_delta_kernel", "flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel",
    "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel", "paged_verify_tc_kernel", "verify_partial",
    "dense_verify_tc_kernel", "ssm_scan_kernel", "ssm_scan_bwd_kernel", "sum_partials_kernel",
)

#: float32 products outside the tensor cores: the H100 data sheet's 67 TFLOP/s
#: (the fp32 kernels run FMA bodies: the parity checks hold them to 1e-4)
FP32_PEAK_FLOPS = 67e12


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One call of a kernel entry point: ``counter`` is its key in
    ``ops.launch_counts()``; ``kernels`` the ``(CUDA kernel symbol,
    launches)`` pairs the call launches; ``dtype`` the products' operand
    type, whose peak bounds the operations."""

    counter: str
    kernels: tuple
    flops: float
    bytes: float
    transcendentals: float
    dtype: torch.dtype

    @property
    def launches(self) -> int:
        return sum(n for _, n in self.kernels)


def peak_flops(dtype: torch.dtype, hw=None) -> float:
    """The peak the products of ``dtype`` run at on ``hw`` (a
    ``core.hardware.HardwareSpec``, the H100 by default): ``hw.peak_flops``
    (bf16 / fp16 on the tensor cores) or, for float32, ``FP32_PEAK_FLOPS``."""
    return FP32_PEAK_FLOPS if dtype == torch.float32 else _hw(hw).peak_flops


def _hw(hw):
    from repro_torch.core.hardware import H100  # the core package imports the models

    return H100 if hw is None else hw


def bound_s(cost: KernelCost, hw=None) -> tuple[float, str]:
    """``(seconds, "bytes" | "operations")``: the least time ``hw`` (the
    H100 by default) could take for ``cost``'s work, and which of the two
    terms sets it."""
    hw = _hw(hw)
    t_bytes = cost.bytes / hw.hbm_bandwidth
    t_ops = cost.flops / peak_flops(cost.dtype, hw)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _values(t: torch.Tensor):
    """``t``'s values as Python numbers, or None on ``meta``."""
    return None if t.is_meta else t.tolist()


def _launch(symbols, empty: bool) -> tuple:
    """One launch of each of ``symbols``, none for an empty batch (the
    launch entries return before launching)."""
    return () if empty else tuple((s, 1) for s in symbols)


def _unique_kv_rows(block_tables: torch.Tensor, needed, page: int) -> int:
    """Distinct (physical page, offset) K/V rows the slots' first
    ``needed[b]`` key positions name: what a perfect kernel reads once
    (slots sharing a radix prefix share pages)."""
    b, w = block_tables.shape
    cap = (w - 1) * page
    pos = torch.arange(cap, device=block_tables.device)
    live = pos[None, :] < torch.tensor(needed, device=block_tables.device)[:, None]
    rows = block_tables[:, pos // page].long() * page + pos % page
    return int(torch.unique(rows[live]).numel())


def _paged_kv(block_tables: torch.Tensor, lengths, page: int):
    """(needed keys per slot, distinct K/V rows read) over a page table."""
    b, w = block_tables.shape
    cap = (w - 1) * page
    if block_tables.is_meta or lengths is None:
        return [cap] * b, b * cap
    needed = [min(max(int(n), 0), cap) for n in lengths]
    return needed, _unique_kv_rows(block_tables, needed, page)


def _tc(q: torch.Tensor) -> bool:
    """Whether the prefill / verify kernels take their tensor-core body."""
    return prefill_body(q.dtype, q.shape[-1]) == "tc"


# ---------------------------------------------------------------------------
# the decode kernels (#1, #3 and its partial form, the merge)
# ---------------------------------------------------------------------------


def paged_decode(q, k_pool, v_pool, block_tables, lengths) -> KernelCost:
    """#1: q in and out, the distinct K/V rows the slots' lengths need, the
    table and lengths; QK^T and PV over each slot's live keys."""
    b, h, hd = q.shape
    kvh, page = k_pool.shape[2], k_pool.shape[1]
    needed, rows = _paged_kv(block_tables, _values(lengths), page)
    keys = sum(needed)
    nbytes = (2 * b * h * hd * q.element_size() + 2 * rows * kvh * hd * k_pool.element_size()
              + block_tables.numel() * 4 + b * 4)
    return KernelCost("paged_decode_attention",
                      _launch(["paged_decode_cluster_kernel"], b == 0),
                      4 * hd * h * keys, nbytes, h * keys, q.dtype)


def _dense_keys(k, lengths) -> int:
    b, s = k.shape[:2]
    vals = _values(lengths)
    return b * s if vals is None else sum(min(max(int(n), 0), s) for n in vals)


def decode(q, k, v, lengths) -> KernelCost:
    """#3: q in and out, each slot's live K/V rows (in the cache's own
    type: an 8-bit cache moves a byte a value), lengths."""
    b, h, hd = q.shape
    kvh = k.shape[2]
    keys = _dense_keys(k, lengths)
    fp8 = k.element_size() == 1
    nbytes = 2 * b * h * hd * q.element_size() + 2 * keys * kvh * hd * k.element_size() + b * 4
    return KernelCost("decode_attention_fp8" if fp8 else "decode_attention",
                      _launch(["dense_decode_cluster_kernel"], b == 0),
                      4 * hd * h * keys, nbytes, h * keys, q.dtype)


def decode_partial(q, k, v, lengths) -> KernelCost:
    """#3's partial form over one block of a sequence-split cache: q in,
    the block's live K/V rows, lengths, the fp32 state (acc, m, l) out."""
    b, h, hd = q.shape
    kvh = k.shape[2]
    keys = _dense_keys(k, lengths)
    fp8 = k.element_size() == 1
    nbytes = (b * h * hd * q.element_size() + 2 * keys * kvh * hd * k.element_size() + b * 4
              + b * h * (hd + 2) * 4)
    return KernelCost("decode_attention_partial_fp8" if fp8 else "decode_attention_partial",
                      _launch(["dense_decode_partial_kernel"], b == 0),
                      4 * hd * h * keys, nbytes, h * keys, q.dtype)


def combine(acc, ml, dtype) -> KernelCost:
    """The merge of n blocks' partial states (``paged::combine_splits``):
    the states in, the output out; per block and row a rescale and sum of
    acc (2 hd) and of (m, l) (4)."""
    b, n, h, hd = acc.shape
    nbytes = n * b * h * (hd + 2) * 4 + b * h * hd * dtype.itemsize
    return KernelCost("combine_splits", _launch(["combine_splits"], b == 0),
                      n * b * h * (2 * hd + 4), nbytes, n * b * h, dtype)


# ---------------------------------------------------------------------------
# the chunked prefill kernels (#2, #4)
# ---------------------------------------------------------------------------


def _chunks(starts, chunk_lens, b: int, c: int, cap: int):
    """(starts, chunk lengths) as lists; on ``meta`` every chunk full and
    ending at the capacity."""
    st, cl = _values(starts), _values(chunk_lens)
    if st is None or cl is None:
        return [max(cap - c, 0)] * b, [c] * b
    return [int(x) for x in st], [int(x) for x in cl]


def _prefill_work(st, cl, h, hd, cap):
    """(keys each slot needs, QK^T + PV operations): row j of a chunk at
    start s sees keys 0 .. s + j."""
    needed = [min(s + c, cap) if c else 0 for s, c in zip(st, cl)]
    pairs = sum(min(s + j + 1, cap) for s, c in zip(st, cl) for j in range(c))
    return needed, 4 * hd * h * pairs, h * pairs


def paged_prefill(q, k_pool, v_pool, block_tables, starts, chunk_lens) -> KernelCost:
    """#2: the chunks' real q rows in, every out row written, the distinct
    K/V rows each slot's prefix and chunk need, the table, starts and
    lengths; QK^T and PV over each real row's causal window."""
    b, c, h, hd = q.shape
    page, kvh = k_pool.shape[1], k_pool.shape[2]
    cap = (block_tables.shape[1] - 1) * page
    st, cl = _chunks(starts, chunk_lens, b, c, cap)
    needed, flops, trans = _prefill_work(st, cl, h, hd, cap)
    rows = (sum(needed) if block_tables.is_meta
            else _unique_kv_rows(block_tables, needed, page))
    isz = q.element_size()
    nbytes = (sum(cl) * h * hd * isz + b * c * h * hd * isz
              + 2 * rows * kvh * hd * k_pool.element_size() + block_tables.numel() * 4 + 2 * b * 4)
    symbol = "paged_prefill_tc_kernel" if _tc(q) else "paged_prefill_kernel"
    return KernelCost("paged_prefill_attention", _launch([symbol], b == 0 or c == 0),
                      flops, nbytes, trans, q.dtype)


def prefill(q, k, v, starts, chunk_lens) -> KernelCost:
    """#4: as #2 over a dense cache (every needed row distinct)."""
    b, c, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    st, cl = _chunks(starts, chunk_lens, b, c, s)
    needed, flops, trans = _prefill_work(st, cl, h, hd, s)
    isz = q.element_size()
    nbytes = (sum(cl) * h * hd * isz + b * c * h * hd * isz
              + 2 * sum(needed) * kvh * hd * k.element_size() + 2 * b * 4)
    symbol = "dense_prefill_tc_kernel" if _tc(q) else "dense_prefill_kernel"
    return KernelCost("prefill_attention", _launch([symbol], b == 0 or c == 0),
                      flops, nbytes, trans, q.dtype)


# ---------------------------------------------------------------------------
# full-sequence attention (#5)
# ---------------------------------------------------------------------------


def _flash_pairs(q, k, causal: bool) -> int:
    b, h, sq = q.shape[:3]
    sk = k.shape[2]
    return b * h * sq * (sq + 1) // 2 if causal else b * h * sq * sk


def flash_fwd(q, k, v, causal: bool) -> KernelCost:
    """#5 forward over the kernel's layout (q [B, H, Sq, hd], K / V already
    expanded to H heads): q, k, v in, out and the fp32 row log-sum-exp out;
    QK^T and PV over the (q, k) pairs the mask keeps."""
    b, h, sq, hd = q.shape
    isz, pairs = q.element_size(), _flash_pairs(q, k, causal)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * isz + b * h * sq * 4
    symbol = "flash_fwd_tc_kernel" if q.dtype == torch.bfloat16 else "flash_fwd_kernel"
    return KernelCost("flash_attention_fwd", _launch([symbol], q.numel() == 0),
                      4 * pairs * hd, nbytes, pairs, q.dtype)


def flash_bwd(q, k, v, causal: bool) -> KernelCost:
    """#5 backward, its three kernels (D = rowsum(dO * O), dK / dV, dQ): q,
    k, v, out, dout and the log-sum-exp in, dq, dk, dv out; five products
    over the kept pairs (S and dP recomputed, dV, dK, dQ)."""
    b, h, sq, hd = q.shape
    isz, pairs = q.element_size(), _flash_pairs(q, k, causal)
    nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * isz + b * h * sq * 4
    tc = "_tc" if q.dtype == torch.bfloat16 else ""
    symbols = ["flash_bwd_delta_kernel", f"flash_bwd_dkdv{tc}_kernel", f"flash_bwd_dq{tc}_kernel"]
    return KernelCost("flash_attention_bwd", _launch(symbols, q.numel() == 0),
                      10 * pairs * hd, nbytes, pairs, q.dtype)


# ---------------------------------------------------------------------------
# the verify kernels (#6 - #9)
# ---------------------------------------------------------------------------


def _seen(lengths, anc, b: int, t: int, cap: int) -> int:
    """(row, key) pairs visible to a verify chunk's T queries: query t of a
    slot of length n sees kpos <= n - T + t, a tree node kpos < n - T plus
    the nodes its ancestor mask sets, within the capacity; on ``meta``
    every slot at its capacity (a chain's window, a tree's ancestors
    counted as the chain's)."""
    lens = _values(lengths)
    if lens is None:
        return b * sum(min(cap - t + j + 1, cap) for j in range(t))
    masks = _values(anc) if anc is not None else None
    seen = 0
    for i, n in enumerate(int(x) for x in lens):
        base = n - t
        for j in range(t):
            if masks is None:
                seen += min(max(base + j + 1, 0), cap)
            else:
                bits = int(masks[i][j])
                seen += min(max(base, 0), cap) + sum(
                    1 for a in range(t) if (bits >> a) & 1 and 0 <= base + a < cap)
    return seen


def paged_verify(q, k_pool, v_pool, block_tables, lengths, anc=None) -> KernelCost:
    """#7 (#9 with ``anc``): q in and out, the distinct K/V rows the slots'
    lengths need, the table, lengths (and the tree's masks); QK^T and PV
    over the pairs each query sees.  Two launches: the split pass and
    ``combine_splits``."""
    b, t, h, hd = q.shape
    page, kvh = k_pool.shape[1], k_pool.shape[2]
    cap = (block_tables.shape[1] - 1) * page
    _, rows = _paged_kv(block_tables, _values(lengths), page)
    seen = _seen(lengths, anc, b, t, cap)
    nbytes = (2 * b * t * h * hd * q.element_size() + 2 * rows * kvh * hd * k_pool.element_size()
              + block_tables.numel() * 4 + b * 4 + (0 if anc is None else anc.numel() * 4))
    split = "paged_verify_tc_kernel" if _tc(q) else "verify_partial"
    return KernelCost("paged_verify_attention" if anc is None else "paged_tree_verify_attention",
                      _launch([split, "combine_splits"], b == 0 or t == 0),
                      4 * hd * h * seen, nbytes, h * seen, q.dtype)


def verify(q, k, v, lengths, anc=None) -> KernelCost:
    """#6 (#8 with ``anc``): q in and out, each slot's live K/V rows,
    lengths (and the masks); QK^T and PV over the pairs each query sees.
    The tensor-core body is one cluster launch, the FMA body a split pass
    and ``combine_splits``."""
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    seen = _seen(lengths, anc, b, t, s)
    nbytes = (2 * b * t * h * hd * q.element_size()
              + 2 * _dense_keys(k, lengths) * kvh * hd * k.element_size() + b * 4
              + (0 if anc is None else anc.numel() * 4))
    one_launch = _tc(q) and dense_verify_plan(s)[1] <= MAX_CLUSTER
    symbols = ["dense_verify_tc_kernel"] if one_launch else ["verify_partial", "combine_splits"]
    return KernelCost("verify_attention" if anc is None else "tree_verify_attention",
                      _launch(symbols, b == 0 or t == 0),
                      4 * hd * h * seen, nbytes, h * seen, q.dtype)


# ---------------------------------------------------------------------------
# the Mamba1 scan (#10) and its backward (#10b)
# ---------------------------------------------------------------------------


def ssm_scan(xi, dt, B_, C_, A, h0) -> KernelCost:
    """#10: xi, dt, y [B, Q, di] and B, C [B, Q, ds] once, A once, h0 and h
    [B, di, ds] once; per (row, step, d, state) dt * A, the exponential, the
    decay of h, the fma with dt * x * B, the product with C and its sum (7),
    and dt * x per (row, step, d)."""
    b, q, di = xi.shape
    ds = B_.shape[-1]
    elems = b * q * di * ds
    nbytes = 4 * (3 * b * q * di + 2 * b * q * ds + di * ds + 2 * b * di * ds)
    return KernelCost("ssm_scan", _launch(["ssm_scan_kernel"], b * q == 0),
                      7 * elems + b * q * di, nbytes, elems, torch.float32)


def ssm_scan_bwd(xi, dt, B_, C_, A, h0) -> KernelCost:
    """#10b: xi, dt, gy in and gxi, gdt out [B, Q, di], B, C in and gB, gC
    out [B, Q, ds], A and gA, h0, the final state's gradient and gh0 once;
    the 20 operations a step back needs per (row, step, d, state).  Two
    launches: the backward and the partials' sum."""
    b, q, di = xi.shape
    ds = B_.shape[-1]
    elems = b * q * di * ds
    nbytes = 4 * (5 * b * q * di + 4 * b * q * ds + 2 * di * ds + 3 * b * di * ds)
    return KernelCost("ssm_scan_bwd",
                      _launch(["ssm_scan_bwd_kernel", "sum_partials_kernel"], b * q == 0),
                      20 * elems, nbytes, elems, torch.float32)
