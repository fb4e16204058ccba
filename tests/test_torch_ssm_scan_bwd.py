"""The selective-scan backward's wrapper on the host (no card needed).

* ``bwd_partials``: one partial gB / gC row per thread-block cluster of 8
  CTAs of 32 d_inner rows, the last cluster padded, at the widths the
  checks use (falcon-mamba's d_inner 8192 gives 32).
* ``ssm_scan_bwd`` and ``ssm_scan_fwd`` raise on CPU tensors and launch
  nothing: the kernel has no fallback.
* Autograd of the plain scan (what the kernel is held to on the card) on
  the CPU: its gradient of ``h0`` is the carry through every step's decay,
  ``gh0 = prod_t a_t * gh`` when y's gradient is zero.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssm_scan as ss


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("di, parts", [(1, 1), (99, 1), (100, 1), (256, 1), (257, 2),
                                       (2400, 10), (8192, 32), (8288, 33)])
def test_bwd_partials_one_per_cluster(di, parts):
    assert ss.bwd_partials(di) == parts
    assert ss.bwd_partials(di) == -(-di // (ss.ROWS_PER_CTA * ss.CLUSTER_CTAS))


def _inputs(b=2, q=20, di=8, ds=4, seed=0):
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((b, q, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, q, di)) - 2)).astype(np.float32)
    bm = rng.standard_normal((b, q, ds)).astype(np.float32)
    cm = rng.standard_normal((b, q, ds)).astype(np.float32)
    a = -np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32), (di, ds)).copy()
    h0 = rng.standard_normal((b, di, ds)).astype(np.float32)
    return [torch.from_numpy(x) for x in (xi, dt, bm, cm, a, h0)]


@pytest.mark.parametrize("fn", ["ssm_scan_fwd", "ssm_scan_bwd"])
def test_kernel_wrappers_raise_on_cpu_tensors(fn):
    args = _inputs()
    before = (ss.COUNTS["cuda"], ss.BWD_COUNTS["cuda"])
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "ssm_scan_fwd":
            ss.ssm_scan_fwd(*args)
        else:
            b, q, di = args[0].shape
            hs = torch.zeros((b, -(-q // ss.CHECKPOINT_STEPS), di, args[2].shape[-1]))
            ss.ssm_scan_bwd(*args[:5], hs, torch.zeros_like(args[0]))
    assert (ss.COUNTS["cuda"], ss.BWD_COUNTS["cuda"]) == before


def test_plain_h0_gradient_is_the_decayed_carry():
    xi, dt, bm, cm, a, h0 = _inputs(seed=1)
    h0.requires_grad_(True)
    y, h = ss.ssm_scan_chunk_torch(xi, dt, bm, cm, a, h0)
    gh = torch.from_numpy(np.random.default_rng(2).standard_normal(h.shape).astype(np.float32))
    (g,) = torch.autograd.grad((y, h), (h0,), (torch.zeros_like(y), gh))
    want = torch.exp(dt.sum(1)[..., None] * a) * gh  # prod_t exp(dt_t A) = exp(sum_t dt_t A)
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)
