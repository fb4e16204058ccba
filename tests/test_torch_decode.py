"""The paged and dense decode kernels' cluster route, on the CPU: the shape-
only plan (``decode_plan``) and a numpy emulation of what
``csrc/decode_cluster.cuh`` computes -- in fp32, in the kernel's units and
order -- held to the plain version (``decode_core``) and, for the paged
kernel, to the reference's Pallas kernel (interpret mode on the CPU).  The
kernels themselves run only on the card (``chip_smoke.py``).  Inputs come
from numpy seeds; tolerance atol 1e-5 (fp32 softmax attention, sums in
another order)."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as tdd
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as tdec

ATOL = 1e-5
LOG2E = 1.4426950408889634


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _slot_key_counts():
    """Every slot width the plan must cover: dense S = 1 .. 4096, and paged
    tables of (W - 1) * page keys at page 8 and 16 up to 4096."""
    return sorted(set(range(1, 4097)) | {n * p for p in (8, 16) for n in range(1, 4096 // p + 1)})


def test_decode_plan_covers_every_tile_once_in_rank_order():
    """Rank r walks tiles r * per .. r * per + per - 1: over the cluster the
    ranks name every 64-key tile of the slot once, in order, the last rank
    is not empty, and a cluster has at most MAX_CLUSTER CTAs."""
    for n in _slot_key_counts():
        per, cluster = tdd.decode_plan(n)
        n_tiles = -(-n // tdd.DECODE_KEYS)
        walked = [t for r in range(cluster) for t in range(r * per, min((r + 1) * per, n_tiles))]
        assert walked == list(range(n_tiles)), n
        assert 1 <= cluster <= tdd.MAX_CLUSTER and (cluster - 1) * per < n_tiles, n
        assert per == max(tdd.DECODE_TILES_PER_CTA, -(-n_tiles // tdd.MAX_CLUSTER)), n
    assert tdd.decode_plan(512) == (2, 4)  # the serving table: one wave of 256 CTAs
    assert tdd.decode_plan(4096) == (8, 8)


def test_decode_plan_reads_no_length():
    """The plan is a function of the slot's width alone, so the engine's
    captured decode graph replays with any lengths."""
    assert list(inspect.signature(tdd.decode_plan).parameters) == ["n_keys"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_cta_fits_in_shared_memory(dtype):
    """At the largest rows the kernels take (MAX_ROW_BYTES) and every group
    width, a CTA's ring, softmax state and block-table entries fit in the
    card's shared memory at every plan up to 4,096 keys; the merge state
    fits in the ring it reuses."""
    isz = torch.empty((), dtype=dtype).element_size()
    hd = tdd.MAX_ROW_BYTES // isz
    for page in (8, 16):
        for ncols in range(1, 4096 // page + 1):
            per, _ = tdd.decode_plan(ncols * page)
            for group in (1, 2, 3, 7, 8, 16):
                need = tdd.decode_smem_bytes(group, hd, isz, tdec.table_ints(per, page))
                assert need <= tdd.MAX_SMEM
    for group in (1, 2, 4, 7):
        g = tdd.rows_per_cta(group)
        ring = 2 * 2 * tdd.DECODE_KEYS * 8 * isz  # the smallest rows: hd 8
        assert 4 * (4 * g * 8 + g * 8 + 2 * g) <= ring


def test_rows_per_cta_and_head_dims():
    assert [tdd.rows_per_cta(g) for g in (1, 2, 3, 4, 5, 7, 8, 16)] == [1, 2, 4, 4, 4, 4, 4, 4]
    for hd, dtype in ((8, torch.bfloat16), (256, torch.bfloat16), (128, torch.float32),
                      (16, torch.float32)):
        tdd.check_head_dim(hd, dtype)
    for hd, dtype in ((12, torch.bfloat16), (264, torch.bfloat16), (256, torch.float32)):
        with pytest.raises(ValueError):
            tdd.check_head_dim(hd, dtype)


# ---------------------------------------------------------------------------
# the numpy emulation of the cluster route
# ---------------------------------------------------------------------------


def _merge(states):
    """(m, l, O) of states merged in list order: M = the largest m of those
    that saw a key (l > 0), each weighed by exp2(m - M) (log2 units)."""
    ms, ls, os_ = zip(*states)
    saw = [li > 0 for li in ls]
    M = np.max([np.where(sw, mi, -np.inf) for sw, mi in zip(saw, ms)], axis=0).astype(np.float32)
    L = np.zeros_like(ls[0])
    O = np.zeros_like(os_[0])
    for sw, mi, li, oi in zip(saw, ms, ls, os_):
        w = np.where(sw, np.exp2(np.where(sw, mi - np.where(sw, M, 0), 0)), 0).astype(np.float32)
        L = (L + w * li).astype(np.float32)
        O = (O + w[:, None] * oi).astype(np.float32)
    return M, L, O


def _cluster_emulation(q, rows_of, n_keys, lengths, kvh):
    """What the decode kernels compute, per (slot, kv head): q scaled by
    hd^-0.5 log2 e; the cluster's CTA of rank r walks 64-key tiles r * per
    .. r * per + per - 1 below min(length, n_keys); warp w of a CTA keeps
    its own (m, l, O) over keys w * 16 .. w * 16 + 15 of each tile (p =
    exp2(s - m), a row that saw nothing subtracts 0); the CTA merges its
    warps in warp order, the cluster its CTAs in rank order; a row no key
    reached gives zeros.  ``rows_of(b, kpos)`` -> the slot's K and V rows
    [n, kvH, hd] at key positions ``kpos``."""
    b, h, hd = q.shape
    group = h // kvh
    per, cluster = tdd.decode_plan(n_keys)
    keys = tdd.DECODE_KEYS
    sl2 = np.float32(hd**-0.5 * LOG2E)
    out = np.zeros_like(q)
    for s in range(b):
        kmax = max(0, min(int(lengths[s]), n_keys))
        for head in range(kvh):
            rows = slice(head * group, (head + 1) * group)
            qs = (q[s, rows] * sl2).astype(np.float32)
            ranks = []
            for r in range(cluster):
                k_lo = r * per * keys
                kend = min(k_lo + per * keys, kmax)
                warps = [(np.full(group, -np.inf, np.float32), np.zeros(group, np.float32),
                          np.zeros((group, hd), np.float32)) for _ in range(4)]
                for k0 in range(k_lo, kend, keys):
                    for w in range(4):
                        a, e = k0 + 16 * w, min(k0 + 16 * w + 16, kend)
                        if e <= a:
                            continue
                        kk, vv = (x[:, head] for x in rows_of(s, np.arange(a, e)))
                        sc = qs @ kk.T
                        m, l, o = warps[w]
                        mx = np.maximum(m, sc.max(axis=1))
                        bb = np.where(mx == -np.inf, 0, mx).astype(np.float32)
                        p = np.exp2(sc - bb[:, None]).astype(np.float32)
                        corr = np.exp2(m - bb).astype(np.float32)
                        warps[w] = (mx, (l * corr + p.sum(axis=1)).astype(np.float32),
                                    (o * corr[:, None] + p @ vv).astype(np.float32))
                ranks.append(_merge(warps))
            _, L, O = _merge(ranks)
            out[s, rows] = np.where(L[:, None] > 0, O / np.where(L > 0, L, 1)[:, None], 0)
    return out


DENSE_EMU_CASES = [
    # (seed, b, h, kvh, hd, S, lengths): S sets the cluster -- 64 -> 1 CTA,
    # 200 -> 2, 384 -> 3, 512 -> 4, 640 -> 5, 768 -> 6, 900 -> 8 (2 tiles a
    # CTA), 1100 -> 6 (3 tiles), 4096 -> 8 (8 tiles); lengths 0, 1, at tile
    # and warp edges, S and past S; groups 1, 2 and 7
    (0, 4, 4, 2, 16, 64, [0, 1, 17, 64]),
    (1, 4, 2, 2, 16, 200, [63, 64, 65, 250]),
    (2, 3, 14, 2, 16, 384, [128, 129, 383]),
    (3, 5, 4, 2, 32, 512, [0, 1, 63, 512, 600]),
    (4, 2, 4, 4, 8, 640, [127, 640]),
    (5, 3, 14, 2, 16, 768, [767, 16, 255]),
    (6, 3, 4, 2, 16, 900, [900, 899, 129]),
    (7, 2, 2, 1, 16, 1100, [1100, 577]),
    (8, 3, 4, 2, 8, 4096, [4096, 3000, 65]),
]


@pytest.mark.parametrize("case", DENSE_EMU_CASES, ids=lambda c: f"seed{c[0]}")
def test_dense_decode_cluster_emulation_matches_plain(case):
    seed, b, h, kvh, hd, s, lengths = case
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    emu = _cluster_emulation(q, lambda slot, kpos: (k[slot, kpos], v[slot, kpos]), s, lens, kvh)
    plain = tdd.decode_core(_t(q), _t(k), _t(v), _t(lens))
    assert np.isfinite(emu).all()
    np.testing.assert_allclose(emu, plain.numpy(), rtol=0, atol=ATOL)
    assert not emu[lens <= 0].any()


PAGED_EMU_CASES = [
    # (seed, b, h, kvh, hd, page, ncols, lengths): slot 1's first pages are
    # slot 0's (a radix-shared prefix); clusters of 1, 2, 4 and 8
    (0, 4, 4, 2, 16, 8, 8, [0, 1, 64, 63]),
    (1, 3, 4, 4, 16, 16, 8, [65, 128, 100]),
    (2, 3, 14, 2, 16, 16, 32, [512, 300, 0]),
    (3, 2, 2, 2, 16, 8, 128, [1024, 129]),
    (4, 2, 4, 2, 8, 16, 256, [4096, 4001]),
]


def _paged_case(seed, b, h, kvh, hd, page, ncols):
    rng = np.random.default_rng(seed)
    pool_n = 1 + b * ncols
    k_pool = rng.standard_normal((pool_n, page, kvh, hd)).astype(np.float32)
    v_pool = rng.standard_normal((pool_n, page, kvh, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, pool_n)).reshape(b, ncols)
    shared = min(4, ncols)
    bt[1, :shared] = bt[0, :shared]
    bt = np.concatenate([bt, np.zeros((b, 1), np.int64)], axis=1).astype(np.int32)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    return q, k_pool, v_pool, bt


@pytest.mark.parametrize("case", PAGED_EMU_CASES, ids=lambda c: f"seed{c[0]}")
def test_paged_decode_cluster_emulation_matches_plain(case):
    seed, b, h, kvh, hd, page, ncols, lengths = case
    q, k_pool, v_pool, bt = _paged_case(seed, b, h, kvh, hd, page, ncols)
    lens = np.asarray(lengths, np.int32)

    def rows_of(slot, kpos):  # the kernel's address: page table[kpos / page], row kpos % page
        pages = bt[slot, kpos // page]
        return k_pool[pages, kpos % page], v_pool[pages, kpos % page]

    emu = _cluster_emulation(q, rows_of, ncols * page, lens, kvh)
    plain = tdec.paged_decode_attention_torch(_t(q), _t(k_pool), _t(v_pool), _t(bt), _t(lens))
    assert np.isfinite(emu).all()
    np.testing.assert_allclose(emu, plain.numpy(), rtol=0, atol=ATOL)
    assert not emu[lens == 0].any()
    if case[0] == 0:  # and the reference's Pallas kernel, in interpret mode
        ref = jops.paged_decode_attention(*(jnp.asarray(a) for a in (q, k_pool, v_pool, bt, lens)),
                                          impl="pallas")
        np.testing.assert_allclose(emu, np.asarray(ref), rtol=0, atol=ATOL)


def test_decode_plain_versions_count_no_launch():
    ops.reset_launch_counts()
    q = torch.zeros((2, 4, 16))
    kv = torch.zeros((2, 8, 2, 16))
    lens = torch.tensor([3, 0], dtype=torch.int32)
    for impl in ("auto", "torch"):
        ops.decode_attention(q, kv, kv, lens, impl=impl)
    assert ops.launch_counts()["decode_attention"] == {"cuda": 0, "torch": 2}
    ops.reset_launch_counts()
