"""The kernels' cost functions (``repro_torch.kernels.cost``) and the
counting hook of ``kernels/ops.py``, on the CPU.

* (a) At the shapes and lengths of ``PERF.md``'s kernel table (``chip_smoke.py``
  phase 3: paged B=8, H=16, kvH=8, hd=128, page 16, 32 table columns with
  slot 1 sharing slot 0's first 4 pages; dense S=512; flash B=4, H=16,
  S=1024, causal; the scan at falcon-mamba's d_inner 8192, ds 16) each
  function gives the table's bound column to the four decimals printed,
  and the term (bytes / operations) that sets it.
* (b) On ``meta`` tensors (no values) a function counts every slot full.
* (c) Under a ``launch.cost.CountingMode`` every entry point of
  ``kernels/ops.py`` records its kernels as the card launches them (the
  paged verify's split pass and combine, the flash backward's three
  kernels, the scan's backward and partials' sum) and returns outputs of
  the kernel's shapes without running the plain version; outside the mode
  a CPU tensor runs the plain version, as before, and "cuda" on a CPU
  tensor raises.
"""
import pytest
import torch

from repro_torch.kernels import cost as K
from repro_torch.kernels import ops
from repro_torch.launch.cost import CountingMode
from repro_torch.spec.tree import linear_chain, tree_ancestor_masks

B, H, KVH, HD, PAGE, NCOLS, CHUNK, DENSE_S = 8, 16, 8, 128, 16, 32, 32, 512
DECODE_LENGTHS = [512, 300, 0, 17, 1, 256, 511, 100]
DENSE_LENGTHS = [0, 512, 300, 17, 1, 256, 511, 100]
PREFILL_STARTS = [0, 64, 100, 480, 0, 33, 256, 16]
PREFILL_LENS = [32, 0, 17, 32, 1, 5, 32, 20]
VERIFY_LENGTHS = [1, 300, 4, 0, 512, 17, 256, 100]
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _i32(xs):
    return torch.tensor(xs, dtype=torch.int32)


def _table():
    """A permutation of the pool's pages, slot 1 sharing slot 0's first 4
    (a radix-shared prefix), and the sentinel column."""
    perm = torch.randperm(B * NCOLS, generator=torch.Generator().manual_seed(0)) + 1
    bt = perm.reshape(B, NCOLS).to(torch.int32)
    bt[1, :4] = bt[0, :4]
    return torch.cat([bt, torch.zeros((B, 1), dtype=torch.int32)], 1)


def _pool():
    return torch.empty((1 + B * NCOLS, PAGE, KVH, HD), dtype=BF16)


def _dense(s=DENSE_S):
    return torch.empty((B, s, KVH, HD), dtype=BF16)


def _chain():
    return torch.tensor(tree_ancestor_masks(linear_chain(4)), dtype=torch.int32).expand(
        B, 5).contiguous()


def _scan(b, q, di=8192, ds=16):
    seq, state = torch.empty((b, q, di)), torch.empty((b, q, ds))
    return seq, seq, state, state, torch.empty((di, ds)), torch.empty((b, di, ds))


def _q(*shape):
    return torch.empty(shape, dtype=BF16)


#: (row of the table, the call, the printed bound ms, bound by)
TABLE = [
    ("#1 paged decode", lambda: K.paged_decode(_q(B, H, HD), _pool(), _pool(), _table(),
                                               _i32(DECODE_LENGTHS)), "0.0020", "bytes"),
    ("#2 paged prefill", lambda: K.paged_prefill(_q(B, CHUNK, H, HD), _pool(), _pool(),
                                                 _table(), _i32(PREFILL_STARTS),
                                                 _i32(PREFILL_LENS)), "0.0017", "bytes"),
    ("#3 dense decode (H = 8)", lambda: K.decode(_q(B, 8, HD), _dense(), _dense(),
                                                 _i32(DENSE_LENGTHS)), "0.0021", "bytes"),
    ("#4 dense prefill (H = 8)", lambda: K.prefill(_q(B, CHUNK, 8, HD), _dense(), _dense(),
                                                   _i32(PREFILL_STARTS), _i32(PREFILL_LENS)),
     "0.0015", "bytes"),
    ("#4 dense prefill (H = 16)", lambda: K.prefill(_q(B, CHUNK, H, HD), _dense(), _dense(),
                                                    _i32(PREFILL_STARTS),
                                                    _i32(PREFILL_LENS)), "0.0017", "bytes"),
    ("#5 flash forward", lambda: K.flash_fwd(*[_q(4, H, 1024, HD)] * 3, True), "0.0201",
     "bytes"),
    ("#5 flash backward", lambda: K.flash_bwd(*[_q(4, H, 1024, HD)] * 3, True), "0.0435",
     "operations"),
    ("#6 dense verify", lambda: K.verify(_q(B, 5, H, HD), _dense(), _dense(),
                                         _i32(VERIFY_LENGTHS)), "0.0016", "bytes"),
    ("#7 paged verify", lambda: K.paged_verify(_q(B, 5, H, HD), _pool(), _pool(), _table(),
                                               _i32(VERIFY_LENGTHS)), "0.0016", "bytes"),
    ("#8 dense tree verify", lambda: K.verify(_q(B, 5, H, HD), _dense(), _dense(),
                                              _i32(VERIFY_LENGTHS), _chain()), "0.0016",
     "bytes"),
    ("#9 paged tree verify", lambda: K.paged_verify(_q(B, 5, H, HD), _pool(), _pool(),
                                                    _table(), _i32(VERIFY_LENGTHS), _chain()),
     "0.0016", "bytes"),
    ("#10 scan, Q = 64", lambda: K.ssm_scan(*_scan(1, 64)), "0.0024", "bytes"),
    ("#10 scan, Q = 256", lambda: K.ssm_scan(*_scan(1, 256)), "0.0080", "bytes"),
    ("#10b scan backward", lambda: K.ssm_scan_bwd(*_scan(4, 1024)), "0.2028", "bytes"),
]


@pytest.mark.parametrize("row, call, printed, by", TABLE, ids=[r[0] for r in TABLE])
def test_cost_functions_give_the_table_bounds(row, call, printed, by):
    seconds, got_by = K.bound_s(call())
    assert f"{seconds * 1e3:.4f}" == printed
    assert got_by == by


def test_verify_counts_what_each_query_sees():
    """A chain's tree verify sees what the chunk verify sees; every query
    of a slot at its capacity sees the whole window."""
    lens = _i32(VERIFY_LENGTHS)
    plain = K.verify(_q(B, 5, H, HD), _dense(), _dense(), lens)
    tree = K.verify(_q(B, 5, H, HD), _dense(), _dense(), lens, _chain())
    assert plain.flops == tree.flops
    assert tree.bytes - plain.bytes == B * 5 * 4  # the masks
    full = K.verify(_q(1, 5, H, HD), _dense()[:1], _dense()[:1], _i32([DENSE_S]))
    assert full.flops == 4 * HD * H * sum(DENSE_S - 5 + j + 1 for j in range(5))


def test_meta_tensors_count_every_slot_full():
    meta = lambda t: t.to("meta")
    got = K.paged_decode(meta(_q(B, H, HD)), meta(_pool()), meta(_pool()), meta(_table()),
                         meta(_i32(DECODE_LENGTHS)))
    full = K.paged_decode(_q(B, H, HD), _pool(), _pool(), _table(),
                          _i32([NCOLS * PAGE] * B))
    # the same keys; the rows read are distinct on meta (no table to share)
    assert got.flops == full.flops
    assert got.bytes - full.bytes == 2 * 4 * PAGE * KVH * HD * 2
    got = K.decode(meta(_q(B, H, HD)), meta(_dense()), meta(_dense()), meta(_i32([0] * B)))
    assert got.flops == K.decode(_q(B, H, HD), _dense(), _dense(), _i32([DENSE_S] * B)).flops


def test_fp8_cache_moves_a_byte_a_value():
    f8 = torch.empty((B, DENSE_S, KVH, HD), dtype=torch.float8_e4m3fn)
    lens = _i32(DENSE_LENGTHS)
    narrow, wide = K.decode(_q(B, H, HD), f8, f8, lens), K.decode(_q(B, H, HD), _dense(),
                                                                   _dense(), lens)
    assert narrow.counter == "decode_attention_fp8" and wide.counter == "decode_attention"
    kv_bytes = 2 * sum(DENSE_LENGTHS) * KVH * HD
    assert wide.bytes - narrow.bytes == kv_bytes
    assert narrow.kernels == wide.kernels == (("dense_decode_cluster_kernel", 1),)


def _entry_points():
    """(name, call, the symbols it launches, output shapes) of every entry
    point of ``kernels/ops.py`` on meta tensors at small shapes (bf16 at hd
    64: the tensor-core bodies).  Besides its kernels, ``attention`` makes
    the kernel's layout: q, and K / V expanded to the q heads, copied
    [B, H, S, hd] (5 copies at GQA group 2)."""
    b, h, kvh, hd, page, cols, s = 2, 4, 2, 64, 16, 4, 64
    m = lambda *shape, dtype=BF16: torch.empty(shape, dtype=dtype, device="meta")
    pool = m(1 + b * cols, page, kvh, hd)
    bt = m(b, cols + 1, dtype=torch.int32)
    lens = m(b, dtype=torch.int32)
    anc = m(b, 3, dtype=torch.int32)
    kv = m(b, s, kvh, hd)
    f32 = dict(dtype=torch.float32)
    return [
        ("attention", lambda: ops.attention(m(b, s, h, hd), kv, kv),
         {"flash_fwd_tc_kernel": 1}, [(b, s, h, hd)]),
        ("paged_decode_attention", lambda: ops.paged_decode_attention(m(b, h, hd), pool, pool,
                                                                      bt, lens),
         {"paged_decode_cluster_kernel": 1}, [(b, h, hd)]),
        ("paged_prefill_chunk_attention", lambda: ops.paged_prefill_chunk_attention(
            m(b, 8, h, hd), pool, pool, bt, lens, lens), {"paged_prefill_tc_kernel": 1},
         [(b, 8, h, hd)]),
        ("decode_attention", lambda: ops.decode_attention(m(b, h, hd), kv, kv, lens),
         {"dense_decode_cluster_kernel": 1}, [(b, h, hd)]),
        ("decode_attention_partial", lambda: ops.decode_attention_partial(m(b, h, hd), kv, kv,
                                                                          lens),
         {"dense_decode_partial_kernel": 1}, [(b, h, hd), (b, h, 2)]),
        ("combine_decode_partials", lambda: ops.combine_decode_partials(
            m(b, 3, h, hd, **f32), m(b, 3, h, 2, **f32), BF16), {"combine_splits": 1},
         [(b, h, hd)]),
        ("prefill_chunk_attention", lambda: ops.prefill_chunk_attention(m(b, 8, h, hd), kv, kv,
                                                                        lens, lens),
         {"dense_prefill_tc_kernel": 1}, [(b, 8, h, hd)]),
        ("paged_verify_attention", lambda: ops.paged_verify_attention(m(b, 3, h, hd), pool,
                                                                      pool, bt, lens),
         {"paged_verify_tc_kernel": 1, "combine_splits": 1}, [(b, 3, h, hd)]),
        ("paged_tree_verify_attention", lambda: ops.paged_tree_verify_attention(
            m(b, 3, h, hd), pool, pool, bt, lens, anc),
         {"paged_verify_tc_kernel": 1, "combine_splits": 1}, [(b, 3, h, hd)]),
        ("verify_attention", lambda: ops.verify_attention(m(b, 3, h, hd), kv, kv, lens),
         {"dense_verify_tc_kernel": 1}, [(b, 3, h, hd)]),
        ("tree_verify_attention", lambda: ops.tree_verify_attention(m(b, 3, h, hd), kv, kv,
                                                                    lens, anc),
         {"dense_verify_tc_kernel": 1}, [(b, 3, h, hd)]),
        ("ssm_scan_chunk", lambda: ops.ssm_scan_chunk(
            m(b, 500, 32, **f32), m(b, 500, 32, **f32), m(b, 500, 8, **f32),
            m(b, 500, 8, **f32), m(32, 8, **f32), m(b, 32, 8, **f32)),
         {"ssm_scan_kernel": 1}, [(b, 500, 32), (b, 32, 8)]),
    ]


@pytest.mark.parametrize("name, call, symbols, shapes", _entry_points(),
                         ids=[e[0] for e in _entry_points()])
def test_counting_mode_records_each_entry_point(name, call, symbols, shapes):
    ops.reset_launch_counts()
    with CountingMode() as mode:
        out = call()
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(t.shape) for t in outs] == shapes
    assert dict(mode.kernels) == symbols
    copies = 5 if name == "attention" else 0
    assert mode.launches == sum(symbols.values()) + copies
    assert all(c == {"cuda": 0, "torch": 0} for c in ops.launch_counts().values())


def test_counting_mode_counts_the_backward_kernels():
    """The flash backward as its three kernels and the scan's backward as
    its two, once each, through autograd on meta tensors; the forward's
    saved tensors (out, the log-sum-exp, the scan's checkpoints) stay alive
    until the backward."""
    m = lambda *shape: torch.empty(shape, device="meta", requires_grad=True)
    with CountingMode() as mode:
        q = m(2, 64, 4, 64)
        out = ops.attention(q, q, q)
        xi, bmat = m(2, 100, 32), m(2, 100, 8)
        y, _ = ops.ssm_scan_chunk(xi, xi, bmat, bmat, m(32, 8), m(2, 32, 8))
        torch.autograd.grad((out.float().sum() + y.sum()), [q, xi, bmat])
    assert dict(mode.kernels) == {
        "flash_fwd_kernel": 1, "flash_bwd_delta_kernel": 1, "flash_bwd_dkdv_kernel": 1,
        "flash_bwd_dq_kernel": 1, "ssm_scan_kernel": 1, "ssm_scan_bwd_kernel": 1,
        "sum_partials_kernel": 1}
    assert dict(mode.counters) == {"flash_attention_fwd": 1, "flash_attention_bwd": 3,
                                   "ssm_scan": 1, "ssm_scan_bwd": 2}


def test_plain_versions_outside_the_mode():
    """Outside a counting mode the entry points are as before: a CPU tensor
    runs the plain version, "cuda" on one raises; "torch" inside the mode
    runs the plain version too (its ops counted one by one)."""
    ops.reset_launch_counts()
    q = torch.randn(2, 4, 16)
    kv = torch.randn(2, 8, 2, 16)
    lens = _i32([3, 8])
    want = ops.decode_attention(q, kv, kv, lens)
    assert ops.launch_counts()["decode_attention"] == {"cuda": 0, "torch": 1}
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.decode_attention(q, kv, kv, lens, impl="cuda")
    with CountingMode() as mode:
        got = ops.decode_attention(q, kv, kv, lens, impl="torch")
    assert torch.equal(got, want) and not mode.kernels and mode.launches > 0
    assert ops.launch_counts()["decode_attention"] == {"cuda": 0, "torch": 2}
    with CountingMode(impl="torch") as mode:
        ops.decode_attention(q, kv, kv, lens)
    assert not mode.kernels and ops.COUNTING == []
