"""Port kernels: the plain PyTorch versions of the paged decode, paged
chunked-prefill and flash attention against the reference's Pallas kernels
(run in interpret mode on the CPU, as the reference's own tests run them),
plus the ``impl`` dispatch and the chunked prefill's choice of kernel body.  Inputs come from numpy seeds and go to both packages in
fp32; tolerance atol 1e-5 (fp32 softmax attention, sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as tdec
from repro_torch.kernels import paged_prefill_attention as tpre
from repro_torch.kernels import prefill_attention as tdp

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pool_case(seed, b, h, kvh, hd, page, ncols, share=False):
    """Random pool + shuffled block tables (one sentinel column).  With
    ``share``, slot 1's first page is slot 0's first page (a radix-shared
    prefix page)."""
    rng = np.random.default_rng(seed)
    pool_n = 1 + b * ncols
    k_pool = rng.standard_normal((pool_n, page, kvh, hd)).astype(np.float32)
    v_pool = rng.standard_normal((pool_n, page, kvh, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, pool_n)).reshape(b, ncols)
    if share and b > 1:
        bt[1, 0] = bt[0, 0]
    bt = np.concatenate([bt, np.zeros((b, 1), np.int64)], axis=1).astype(np.int32)
    return rng, k_pool, v_pool, bt


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


DECODE_CASES = [
    # (seed, b, h, kvh, hd, page, ncols, lengths, share)
    (0, 4, 4, 2, 16, 8, 3, [0, 1, 24, 13], True),
    (1, 3, 4, 4, 16, 16, 2, [32, 0, 17], False),
    (2, 2, 8, 2, 32, 8, 4, [9, 32], True),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: f"seed{c[0]}")
def test_decode_plain_matches_pallas(case):
    seed, b, h, kvh, hd, page, ncols, lengths, share = case
    rng, k_pool, v_pool, bt = _pool_case(seed, b, h, kvh, hd, page, ncols, share)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    ref = jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(bt), jnp.asarray(lens), impl="pallas",
    )
    out = ops.paged_decode_attention(
        _t(q), _t(k_pool), _t(v_pool), _t(bt), _t(lens), impl="torch"
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    assert not out[lens == 0].any()  # empty slots are exact zeros


PREFILL_CASES = [
    # (seed, b, c, h, kvh, hd, page, ncols, starts, chunk_lens, share)
    (0, 4, 8, 4, 2, 16, 8, 4, [0, 8, 3, 16], [8, 0, 5, 8], True),
    (1, 3, 16, 4, 4, 16, 8, 4, [8, 0, 10], [16, 3, 0], True),
    (2, 2, 8, 4, 2, 16, 16, 2, [0, 17], [1, 8], False),
    # GQA group 7 (qwen2-7b, deepseek-coder-33b): C * group = 112 rows, more
    # than one 64-row tile of the tensor-core body
    (3, 2, 16, 14, 2, 16, 8, 4, [0, 9], [16, 11], True),
    # hd 64 (musicgen-large)
    (4, 2, 8, 4, 2, 64, 16, 2, [3, 20], [8, 5], False),
    # musicgen-large's serving attention: MHA (GQA group 1) at hd 64
    (5, 2, 8, 4, 4, 64, 16, 2, [3, 20], [8, 5], True),
    # pixtral-12b's GQA group 4 (32 / 8 heads): C * group = 32 rows a kv head
    (6, 3, 8, 8, 2, 16, 8, 4, [0, 11, 25], [8, 6, 3], True),
]


@pytest.mark.parametrize("case", PREFILL_CASES, ids=lambda c: f"seed{c[0]}")
def test_prefill_plain_matches_pallas(case):
    seed, b, c, h, kvh, hd, page, ncols, starts, clens, share = case
    rng, k_pool, v_pool, bt = _pool_case(seed, b, h, kvh, hd, page, ncols, share)
    q = rng.standard_normal((b, c, h, hd)).astype(np.float32)
    st = np.asarray(starts, np.int32)
    cl = np.asarray(clens, np.int32)
    ref = jops.paged_prefill_chunk_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(bt), jnp.asarray(st), jnp.asarray(cl), impl="pallas",
    )
    out = ops.paged_prefill_chunk_attention(
        _t(q), _t(k_pool), _t(v_pool), _t(bt), _t(st), _t(cl), impl="torch"
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    pad = np.arange(c)[None, :] >= cl[:, None]
    assert not out.numpy()[pad].any()  # rows past chunk_lens are exact zeros


@pytest.mark.parametrize("dtype,hd,body", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"), (torch.bfloat16, 80, "fma"),
    (torch.bfloat16, 96, "fma"), (torch.float32, 128, "fma"), (torch.float32, 64, "fma"),
])
def test_prefill_body_route(dtype, hd, body):
    """Both chunked-prefill kernels pick their body from dtype and head dim
    alone: the tensor cores for bf16 at hd 64 / 128, the FMA body else."""
    assert tdp.prefill_body(dtype, hd) == body


@pytest.mark.parametrize(
    "arch", [a for a in jconfigs.ARCH_IDS if jconfigs.get_config(a).num_heads])
def test_prefill_body_of_reference_configs(arch):
    """bf16 prefill of every attention config of the reference takes the
    tensor-core body but zamba2's shared attention (hd 80); fp32 never does."""
    hd = jconfigs.get_config(arch).head_dim
    expected = "fma" if arch == "zamba2-2.7b" else "tc"
    assert tdp.prefill_body(torch.bfloat16, hd) == expected
    assert tdp.prefill_body(torch.float32, hd) == "fma"


def test_body_counts_reset_and_untouched_by_plain_versions():
    ops.reset_launch_counts()
    tpre.BODY_COUNTS["tc"] = 3
    case = PREFILL_CASES[0]
    _, k_pool, v_pool, bt = _pool_case(case[0], 4, 4, 2, 16, 8, 4)
    q = torch.zeros((4, 8, 4, 16))
    st = torch.zeros((4,), dtype=torch.int32)
    ops.paged_prefill_chunk_attention(q, _t(k_pool), _t(v_pool), _t(bt), st, st + 8)
    assert ops.body_counts()["paged_prefill_attention"] == {"tc": 3, "fma": 0}
    assert ops.launch_counts()["paged_prefill_attention"] == {"cuda": 0, "torch": 1}
    ops.reset_launch_counts()
    assert all(c == {"tc": 0, "fma": 0} for c in ops.body_counts().values())
    assert set(ops.body_counts()) == {"paged_prefill_attention", "prefill_attention",
                                      "paged_verify_attention",
                                      "paged_tree_verify_attention", "verify_attention",
                                      "tree_verify_attention"}


def _small_decode_inputs():
    _, k_pool, v_pool, bt = _pool_case(7, 2, 4, 2, 16, 8, 2)
    q = np.ones((2, 4, 16), np.float32)
    lens = np.asarray([5, 9], np.int32)
    return [_t(a) for a in (q, k_pool, v_pool, bt, lens)]


def test_auto_dispatch_runs_plain_version_on_cpu():
    ops.reset_launch_counts()
    args = _small_decode_inputs()
    out_auto = ops.paged_decode_attention(*args, impl="auto")
    out_plain = ops.paged_decode_attention(*args, impl="torch")
    assert torch.equal(out_auto, out_plain)
    counts = ops.launch_counts()["paged_decode_attention"]
    assert counts == {"cuda": 0, "torch": 2}
    ops.reset_launch_counts()
    assert ops.launch_counts()["paged_decode_attention"]["torch"] == 0


def test_cuda_impl_raises_on_cpu_tensors():
    args = _small_decode_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention(*args, impl="cuda")
    q = torch.zeros((2, 8, 4, 16))
    st = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_prefill_chunk_attention(
            q, args[1], args[2], args[3], st, st, impl="cuda"
        )
    with pytest.raises(ValueError, match="unknown"):
        ops.paged_decode_attention(*args, impl="pallas")
    assert tdec.COUNTS["cuda"] == 0 and tpre.COUNTS["cuda"] == 0


# ---------------------------------------------------------------------------
# flash attention (training forward): the plain version against the Pallas
# kernel in interpret mode, heads pre-expanded, fp32, atol 1e-5
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (seed, sq, sk, causal, block, hd): S a multiple of the block, ragged,
    # shorter than a block (the smallest monolithic prefill bucket), and a
    # wider head
    (0, 128, 128, True, 32, 16),
    (1, 100, 100, True, 32, 16),
    (2, 64, 64, False, 32, 16),
    (3, 48, 80, False, 32, 16),
    (4, 8, 8, True, 32, 16),
    (5, 40, 72, False, 32, 64),
    # causal at hd 64 (musicgen-large's training attention), ragged
    (6, 100, 100, True, 32, 64),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: f"seed{c[0]}")
def test_flash_plain_matches_pallas(case):
    from repro.kernels.flash_attention import flash_attention as jflash

    seed, sq, sk, causal, block, hd = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, 2, sq, hd)).astype(np.float32)
    k = rng.standard_normal((1, 2, sk, hd)).astype(np.float32)
    v = rng.standard_normal((1, 2, sk, hd)).astype(np.float32)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                 block_q=block, block_k=block, interpret=True)
    out = tflash.flash_attention_torch(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_attention_dispatch_matches_reference_xla_with_gqa():
    """``ops.attention`` ([B, S, H, hd] layout, kv heads expanded inside)
    against the reference's ``ops.attention(impl="xla")``."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    ref = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, impl="xla")
    out = ops.attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_attention_auto_runs_plain_forward_and_autograd_backward_on_cpu():
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 2, 16), generator=g).requires_grad_() for _ in range(3))
    out = ops.attention(q, k, v, causal=True, impl="auto")
    out.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd"] == {"cuda": 0, "torch": 1}
    assert counts["flash_attention_bwd"] == {"cuda": 0, "torch": 1}


def test_flash_kernel_raises_on_cpu_and_bad_shapes():
    q = torch.zeros((1, 2, 8, 16))
    k = torch.zeros((1, 2, 12, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_fwd(q, q, q, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, q, q, causal=True, impl="cuda")
    with pytest.raises(ValueError, match="Sq == Sk"):
        tflash.flash_attention_torch(q, k, k, causal=True)
    assert tflash.flash_attention_torch(q, k, k, causal=False).shape == q.shape
    assert tflash.FWD_COUNTS["cuda"] == 0 and tflash.BWD_COUNTS["cuda"] == 0
