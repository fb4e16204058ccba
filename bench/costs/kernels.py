"""Operations and bytes of one call of the port's attention kernels, from
shapes and lengths alone: frozen copies of the port's ``kernels/cost.py``
formulas (``flash_fwd``, ``flash_bwd``, ``paged_decode``,
``paged_prefill``), counted as a roofline counts them: each input byte read
once, each output byte written once, the products' multiply-adds as 2.
The kernels' names are the profiler's (a symbol is matched as a substring).
"""
from __future__ import annotations

from costs.model import HBM_BYTES_PER_S, PEAK_BF16_FLOPS

FLASH_FWD = ("flash_fwd_tc_kernel",)
FLASH_BWD = ("flash_bwd_delta_kernel", "flash_bwd_dkdv_tc_kernel", "flash_bwd_dq_tc_kernel")
PAGED_DECODE = ("paged_decode_cluster_kernel",)
PAGED_PREFILL = ("paged_prefill_tc_kernel",)


def bound_s(flops: float, nbytes: float) -> float:
    """Least time on the card: bfloat16 products at the tensor-core peak
    or the bytes at the HBM rate, whichever is longer."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def flash_fwd(b: int, h: int, s: int, hd: int, itemsize: int = 2) -> tuple:
    """Causal forward over ``[b, h, s, hd]`` (K / V expanded to ``h``
    heads): q, k, v in, out and the fp32 log-sum-exp out; QK^T and PV over
    the kept pairs."""
    pairs = b * h * s * (s + 1) // 2
    n = b * h * s * hd
    return 4 * pairs * hd, 4 * n * itemsize + b * h * s * 4


def flash_bwd(b: int, h: int, s: int, hd: int, itemsize: int = 2) -> tuple:
    """Causal backward (D, dK / dV, dQ): q, k, v, out, dout and the
    log-sum-exp in, dq, dk, dv out; five products over the kept pairs."""
    pairs = b * h * s * (s + 1) // 2
    n = b * h * s * hd
    return 10 * pairs * hd, 8 * n * itemsize + b * h * s * 4


def paged_decode(b: int, h: int, kvh: int, hd: int, keys: list, table_cols: int,
                 itemsize: int = 2) -> tuple:
    """One decode launch over ``b`` slots whose live key counts are
    ``keys`` (each key's K / V row distinct): q in and out, the rows, the
    table (``table_cols`` columns a slot) and lengths."""
    k = sum(keys)
    nbytes = 2 * b * h * hd * itemsize + 2 * k * kvh * hd * itemsize + b * table_cols * 4 + b * 4
    return 4 * hd * h * k, nbytes


def paged_prefill(b: int, c: int, h: int, kvh: int, hd: int, chunks: list, table_cols: int,
                  itemsize: int = 2) -> tuple:
    """One chunked-prefill launch over ``b`` slots of ``c`` rows; ``chunks``
    the ``(start, length)`` of each real chunk: its q rows in, every out row
    written, the K / V rows its prefix and itself need, the table, starts
    and lengths; QK^T and PV over each real row's causal window."""
    rows = sum(s + n for s, n in chunks)
    pairs = sum(n * s + n * (n + 1) // 2 for s, n in chunks)
    nbytes = (sum(n for _, n in chunks) * h * hd * itemsize + b * c * h * hd * itemsize
              + 2 * rows * kvh * hd * itemsize + b * table_cols * 4 + 2 * b * 4)
    return 4 * hd * h * pairs, nbytes
