"""Port kernels of the speculative slice: the plain PyTorch versions of the
dense decode, dense chunked prefill, paged chunk-verify and paged
tree-verify attention against the reference's Pallas kernels (interpret mode
on the CPU, as the reference's own tests run them) and its XLA paths, plus
their ``impl`` dispatch.  Inputs come from numpy seeds and go to both
packages in fp32; tolerance atol 1e-5 (fp32 softmax attention, sums in
another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.spec import tree as jtree
from repro_torch.kernels import decode_attention as tdd
from repro_torch.kernels import ops
from repro_torch.kernels import paged_tree_verify_attention as ttree
from repro_torch.kernels import paged_verify_attention as tver
from repro_torch.kernels import prefill_attention as tdp

ATOL = 1e-5
IMPLS = ("pallas", "xla")


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


def _j(a):
    return jnp.asarray(a)


def _dense_case(seed, b, s, kvh, hd):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    return rng, k, v


def _pool_case(seed, b, kvh, hd, page, ncols):
    """Random pool + shuffled block tables with a sentinel last column; slot
    1's first page is slot 0's (a radix-shared prefix page)."""
    rng = np.random.default_rng(seed)
    pool_n = 1 + b * ncols
    k_pool = rng.standard_normal((pool_n, page, kvh, hd)).astype(np.float32)
    v_pool = rng.standard_normal((pool_n, page, kvh, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, pool_n)).reshape(b, ncols)
    bt[1, 0] = bt[0, 0]
    bt = np.concatenate([bt, np.zeros((b, 1), np.int64)], axis=1).astype(np.int32)
    return rng, k_pool, v_pool, bt


# ---------------------------------------------------------------------------
# dense decode (#3): lengths 0, S and past S (the kernel clamps to S)
# ---------------------------------------------------------------------------

DENSE_DECODE_CASES = [
    # (seed, b, h, kvh, hd, s, lengths)
    (0, 4, 4, 4, 16, 40, [0, 1, 40, 57]),
    (1, 3, 8, 2, 32, 64, [64, 13, 0]),
    (2, 2, 4, 2, 16, 24, [200, 9]),
]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", DENSE_DECODE_CASES, ids=lambda c: f"seed{c[0]}")
def test_dense_decode_plain_matches_reference(case, impl):
    seed, b, h, kvh, hd, s, lengths = case
    rng, k, v = _dense_case(seed, b, s, kvh, hd)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    ref = jops.decode_attention(_j(q), _j(k), _j(v), _j(lens), impl=impl)
    out = ops.decode_attention(_t(q), _t(k), _t(v), _t(lens), impl="torch")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    assert not out[lens == 0].any()  # empty slots are exact zeros


# ---------------------------------------------------------------------------
# dense chunked prefill (#4): ragged starts / chunk_lens, a frozen slot,
# GQA group 7, hd 64, chunks past S
# ---------------------------------------------------------------------------

DENSE_PREFILL_CASES = [
    # (seed, b, c, h, kvh, hd, s, starts, chunk_lens)
    (0, 4, 8, 4, 2, 16, 32, [0, 8, 3, 24], [8, 0, 5, 8]),
    (1, 3, 16, 4, 4, 16, 64, [16, 0, 40], [16, 3, 0]),
    (2, 2, 8, 8, 8, 32, 48, [0, 40], [1, 8]),
    # GQA group 7: C * group = 112 rows, more than one 64-row tile
    (3, 2, 16, 14, 2, 16, 40, [0, 20], [16, 11]),
    # hd 64
    (4, 2, 8, 4, 2, 64, 32, [3, 20], [8, 5]),
    # chunks that run past S (keys stop at S)
    (5, 3, 8, 4, 2, 16, 40, [36, 38, 0], [8, 8, 3]),
]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", DENSE_PREFILL_CASES, ids=lambda c: f"seed{c[0]}")
def test_dense_prefill_plain_matches_reference(case, impl):
    seed, b, c, h, kvh, hd, s, starts, clens = case
    rng, k, v = _dense_case(seed, b, s, kvh, hd)
    q = rng.standard_normal((b, c, h, hd)).astype(np.float32)
    st = np.asarray(starts, np.int32)
    cl = np.asarray(clens, np.int32)
    ref = jops.prefill_chunk_attention(_j(q), _j(k), _j(v), _j(st), _j(cl), impl=impl)
    out = ops.prefill_chunk_attention(_t(q), _t(k), _t(v), _t(st), _t(cl), impl="torch")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    pad = np.arange(c)[None, :] >= cl[:, None]
    assert not out.numpy()[pad].any()  # rows past chunk_lens are exact zeros


# ---------------------------------------------------------------------------
# paged chunk-verify (#7): lengths 0 and < T (empty causal windows), a full
# table, and lengths past the table's capacity (not clamped)
# ---------------------------------------------------------------------------

VERIFY_CASES = [
    # (seed, b, t, h, kvh, hd, page, ncols, lengths)
    (0, 4, 3, 4, 2, 16, 8, 3, [0, 2, 24, 13]),
    (1, 3, 5, 4, 4, 16, 16, 2, [32, 5, 1]),
    (2, 4, 2, 8, 2, 32, 8, 4, [9, 32, 45, 2]),
    # musicgen-large's verify: MHA (GQA group 1) at hd 64
    (3, 3, 5, 4, 4, 64, 16, 2, [32, 5, 20]),
    # pixtral-12b's GQA group 4 (32 / 8 heads)
    (4, 4, 5, 8, 2, 16, 8, 4, [9, 32, 45, 2]),
]


def _verify_inputs(case):
    seed, b, t, h, kvh, hd, page, ncols, lengths = case
    rng, k_pool, v_pool, bt = _pool_case(seed, b, kvh, hd, page, ncols)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    return q, k_pool, v_pool, bt, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", VERIFY_CASES, ids=lambda c: f"seed{c[0]}")
def test_paged_verify_plain_matches_reference(case, impl):
    q, k_pool, v_pool, bt, lens = _verify_inputs(case)
    ref = jops.paged_verify_attention(
        _j(q), _j(k_pool), _j(v_pool), _j(bt), _j(lens), impl=impl
    )
    out = ops.paged_verify_attention(
        _t(q), _t(k_pool), _t(v_pool), _t(bt), _t(lens), impl="torch"
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    t = q.shape[1]
    empty = (lens[:, None] - t + np.arange(t)[None, :]) < 0
    assert not out.numpy()[empty].any()  # empty causal windows are exact zeros


# ---------------------------------------------------------------------------
# paged tree-verify (#9): chain == verify, branching trees, N = 31
# ---------------------------------------------------------------------------


def _anc(parents, b):
    return np.broadcast_to(jtree.tree_ancestor_masks(parents), (b, len(parents))).copy()


@pytest.mark.parametrize("case", VERIFY_CASES, ids=lambda c: f"seed{c[0]}")
def test_tree_plain_on_a_chain_equals_verify(case):
    q, k_pool, v_pool, bt, lens = _verify_inputs(case)
    anc = _anc(jtree.linear_chain(q.shape[1] - 1), q.shape[0])
    args = [_t(a) for a in (q, k_pool, v_pool, bt, lens)]
    chain = ops.paged_tree_verify_attention(*args, _t(anc), impl="torch")
    assert torch.equal(chain, ops.paged_verify_attention(*args, impl="torch"))


TREE_CASES = [
    # (seed, parents, page, ncols, lengths)
    (0, jtree.branching_tree(2, 2), 8, 4, [5, 3, 30, 0]),
    (1, (-1, 0, 0, 1, 1, 2, 5), 16, 2, [7, 20, 32, 40]),
    (2, jtree.linear_chain(30), 16, 3, [31, 48, 12, 47]),
    (3, jtree.branching_tree(3, 10), 8, 8, [64, 31, 40, 2]),
]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", TREE_CASES, ids=lambda c: f"seed{c[0]}")
def test_paged_tree_plain_matches_reference(case, impl):
    seed, parents, page, ncols, lengths = case
    b, h, kvh, hd = 4, 4, 2, 16
    rng, k_pool, v_pool, bt = _pool_case(seed, b, kvh, hd, page, ncols)
    n = len(parents)
    q = rng.standard_normal((b, n, h, hd)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    anc = _anc(parents, b)
    ref = jops.paged_tree_verify_attention(
        _j(q), _j(k_pool), _j(v_pool), _j(bt), _j(lens), _j(anc), impl=impl
    )
    out = ops.paged_tree_verify_attention(
        _t(q), _t(k_pool), _t(v_pool), _t(bt), _t(lens), _t(anc), impl="torch"
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_tree_rejects_more_than_31_nodes():
    q = torch.zeros((1, 32, 4, 16))
    pool = torch.zeros((3, 8, 2, 16))
    bt = torch.zeros((1, 3), dtype=torch.int32)
    lens = torch.full((1,), 32, dtype=torch.int32)
    anc = torch.ones((1, 32), dtype=torch.int32)
    for impl in ("torch", "auto"):
        with pytest.raises(ValueError, match="31"):
            ops.paged_tree_verify_attention(q, pool, pool, bt, lens, anc, impl=impl)


# ---------------------------------------------------------------------------
# the paged verify / tree verify's body route and the tensor-core split plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,hd,body", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"), (torch.bfloat16, 80, "fma"),
    (torch.bfloat16, 96, "fma"), (torch.float32, 128, "fma"), (torch.float32, 64, "fma"),
])
def test_verify_body_route(dtype, hd, body):
    """Both paged verify kernels launch through ``launch_verify``, which picks
    the body from dtype and head dim alone: the tensor cores for bf16 at hd
    64 / 128, the FMA body else."""
    assert tver.verify_body(dtype, hd) == body
    assert ttree.launch_verify is tver.launch_verify


@pytest.mark.parametrize("page", [4, 8, 16, 32, 128])
def test_verify_split_plan_covers_every_tile_once(page):
    """For 1..64 table columns, the splits cover every 64-key tile of the
    slot exactly once, none is empty, there are at most TC_MAX_SPLITS of
    them, and one split's tensor-core CTA fits the card's shared memory."""
    for n_cols in range(1, 65):
        n_tiles = -(-n_cols * page // tver.TC_KEYS)
        per, splits = tver.verify_split_plan(n_cols, page)
        covered = [j for s in range(splits) for j in range(s * per, min((s + 1) * per, n_tiles))]
        assert covered == list(range(n_tiles)), (n_cols, per, splits)
        assert 1 <= splits <= tver.TC_MAX_SPLITS and (splits - 1) * per < n_tiles
        assert per == max(tver.TC_TILES_PER_SPLIT, -(-n_tiles // tver.TC_MAX_SPLITS))
        assert tver.tc_smem_bytes(128, per, page, n_cols) <= tver.MAX_SMEM
    # the serving pool's 32 columns of 16: two tiles per split, 4 splits
    assert tver.verify_split_plan(32, 16) == (2, 4)


def test_verify_plain_versions_leave_body_counts_at_zero():
    ops.reset_launch_counts()
    q, k_pool, v_pool, bt, lens = (_t(a) for a in _verify_inputs(VERIFY_CASES[0]))
    anc = _t(_anc(jtree.linear_chain(q.shape[1] - 1), q.shape[0]))
    for impl in ("auto", "torch"):
        ops.paged_verify_attention(q, k_pool, v_pool, bt, lens, impl=impl)
        ops.paged_tree_verify_attention(q, k_pool, v_pool, bt, lens, anc, impl=impl)
    assert ops.launch_counts()["paged_verify_attention"] == {"cuda": 0, "torch": 2}
    assert ops.launch_counts()["paged_tree_verify_attention"] == {"cuda": 0, "torch": 2}
    for name in ("paged_verify_attention", "paged_tree_verify_attention"):
        assert ops.body_counts()[name] == {"tc": 0, "fma": 0}
    ops.reset_launch_counts()


# ---------------------------------------------------------------------------
# dispatch: the plain versions run for CPU tensors; the kernels raise there
# ---------------------------------------------------------------------------


def test_auto_dispatch_counts_and_cuda_raises_on_cpu():
    q3 = torch.zeros((2, 4, 16))
    kv = torch.zeros((2, 8, 2, 16))
    lens = torch.tensor([3, 8], dtype=torch.int32)
    qc = torch.zeros((2, 3, 4, 16))
    pool = torch.zeros((5, 8, 2, 16))
    bt = torch.tensor([[1, 2, 0], [3, 4, 0]], dtype=torch.int32)
    anc = torch.tensor([[1, 3, 7]] * 2, dtype=torch.int32)
    calls = {
        "decode_attention": lambda impl: ops.decode_attention(q3, kv, kv, lens, impl=impl),
        "prefill_attention": lambda impl: ops.prefill_chunk_attention(
            qc, kv, kv, lens, lens, impl=impl),
        "paged_verify_attention": lambda impl: ops.paged_verify_attention(
            qc, pool, pool, bt, lens, impl=impl),
        "paged_tree_verify_attention": lambda impl: ops.paged_tree_verify_attention(
            qc, pool, pool, bt, lens, anc, impl=impl),
    }
    ops.reset_launch_counts()
    for name, call in calls.items():
        assert torch.equal(call("auto"), call("torch"))
        assert ops.launch_counts()[name] == {"cuda": 0, "torch": 2}
        with pytest.raises(ValueError, match="CUDA"):
            call("cuda")
    for mod in (tdd, tdp, tver, ttree):
        assert mod.COUNTS["cuda"] == 0
    ops.reset_launch_counts()
    assert all(c == {"cuda": 0, "torch": 0} for c in ops.launch_counts().values())
