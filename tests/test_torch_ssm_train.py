"""Port's Mamba1 training path (falcon-mamba-7b) against the reference, on
the CPU in fp32.

* The plain selective scan's gradients (autograd of
  ``ssm_scan_chunk_torch``, what the CUDA backward kernel is held to on the
  card) with respect to xi, dt, B, C, A and h0, from a non-zero h0 and a
  non-zero gradient of the final state, against ``jax.grad`` of the
  reference's 64-step XLA scan, at S = 100 (one chunk and a padded tail).
* ``mamba1_block``'s output and its gradients (input and every weight)
  against ``jax.grad`` of the reference's ``impl="xla"`` block, S = 100.
* ``lm_loss`` and its gradients under remat ``"none"``, ``"full"`` and
  ``"dots"`` against ``jax.value_and_grad`` of the reference's; the scan
  runs twice a layer under ``"full"`` (the recompute) and its backward once.
* Three ``make_train_step`` steps against the reference's composition of
  ``repro.optim`` around its loss (``tests/test_torch_train.py``).

Tolerances: each output and gradient max|d| <= 1e-4 * max|ref| (fp32; the
reference's associative scan sums in another order); loss |d| <= 1e-5.
Weights go through ``bridge.params_from_numpy``; inputs come from numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro.optim import make_schedule as jmake_schedule
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import TrainConfig
from repro_torch.data import SyntheticDataset
from repro_torch.kernels import ops
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.runtime import init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_unflatten

JCFG = jconfigs.smoke_config("falcon-mamba-7b")
CFG = configs.smoke_config("falcon-mamba-7b")
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
RTOL = 1e-4
SEQ = 100  # not a multiple of the reference's 64-step chunk or of the kernel's 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    """{"a/b": numpy leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _close(port, ref, name=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(port - ref).max())
    assert err <= RTOL * scale, (name, err, scale)


def _leaf_params(np_tree):
    params = params_from_numpy(np_tree, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def test_plain_scan_grads_match_reference():
    rng = np.random.default_rng(0)
    b, s, di, ds = 2, SEQ, 32, 8
    xi = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)) - 2)).astype(np.float32)
    B_ = rng.standard_normal((b, s, ds)).astype(np.float32)
    C_ = rng.standard_normal((b, s, ds)).astype(np.float32)
    A = -np.broadcast_to(np.arange(1, ds + 1, dtype=np.float32), (di, ds)).copy()
    h0 = rng.standard_normal((b, di, ds)).astype(np.float32)
    wy = rng.standard_normal((b, s, di)).astype(np.float32)
    wh = rng.standard_normal((b, di, ds)).astype(np.float32)
    args = (xi, dt, B_, C_, A, h0)

    def jloss(*a):
        y, h = JSSM.selective_scan_chunked(*a, impl="xla")
        return (y * wy).sum() + (h * wh).sum()

    jg = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    ops.reset_launch_counts()
    y, h = SSM.selective_scan_chunked(*targs, impl="torch")
    loss = (y * torch.from_numpy(wy)).sum() + (h * torch.from_numpy(wh)).sum()
    tg = torch.autograd.grad(loss, targs)
    assert ops.launch_counts()["ssm_scan_bwd"] == {"cuda": 0, "torch": 1}
    for name, t, j in zip(("xi", "dt", "B", "C", "A", "h0"), tg, jg):
        _close(t, j, name)


def test_mamba1_block_output_and_grads_match_reference():
    mixer = {k: v[0] for k, v in NP_PARAMS["layers"]["mixer"].items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, SEQ, CFG.d_model)).astype(np.float32)
    w = rng.standard_normal((2, SEQ, CFG.d_model)).astype(np.float32)

    def jloss(p, xx):
        out = JSSM.mamba1_block(JCFG, p, xx, impl="xla")
        return (out * w).sum(), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, mixer), jnp.asarray(x))
    params = _leaf_params(mixer)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = SSM.mamba1_block(CFG, params, tx)
    _close(out, jout, "out")
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), tree_leaves(params) + [tx])
    _close(grads[-1], jg[1], "x")
    tflat = _flat(tree_unflatten(params, list(grads[:-1])))
    jflat = _flat(jg[0])
    assert tflat.keys() == jflat.keys()
    for name, ref in jflat.items():
        _close(tflat[name], ref, name)


@pytest.mark.parametrize("remat_policy", ["none", "full", "dots"])
def test_lm_loss_and_grads_match_reference(remat_policy):
    rng = np.random.default_rng(2)
    toks = rng.integers(0, CFG.vocab_size, (2, SEQ + 1)).astype(np.int32)
    inputs, labels = toks[:, :-1], toks[:, 1:]

    def jloss(p):
        return JT.lm_loss(JCFG, p, jnp.asarray(inputs), jnp.asarray(labels), impl="xla",
                          remat_policy=remat_policy, compute_dtype=jnp.float32)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, NP_PARAMS))
    params = _leaf_params(NP_PARAMS)
    ops.reset_launch_counts()
    loss, metrics = T.lm_loss(CFG, params, torch.from_numpy(inputs), torch.from_numpy(labels),
                              remat_policy=remat_policy, compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    counts = ops.launch_counts()
    assert abs(loss.item() - float(jl)) <= 1e-5
    assert abs(metrics["ce"].item() - float(jm["ce"])) <= 1e-5
    assert float(metrics["moe_aux"]) == float(jm["moe_aux"]) == 0.0
    n = CFG.num_layers
    forward_scans = n if remat_policy == "none" else 2 * n  # the recompute scans again
    assert counts["ssm_scan"] == {"cuda": 0, "torch": forward_scans}
    assert counts["ssm_scan_bwd"] == {"cuda": 0, "torch": n}
    tflat = _flat(tree_unflatten(params, list(grads)))
    jflat = _flat(jg)
    assert tflat.keys() == jflat.keys()
    for name, ref in jflat.items():
        _close(tflat[name], ref, name)


TRAIN_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10, compute_dtype="float32")


def test_three_train_steps_match_reference_composition():
    """``make_train_step`` on falcon-mamba, the path every family takes,
    against the reference's clip / schedule / AdamW around its loss (its
    own ``make_train_step`` needs a mesh that fails on this JAX, C1)."""
    jtcfg = JTrainConfig(**TRAIN_KW)
    sched = jmake_schedule(jtcfg)

    @jax.jit
    def jstep(state, batch):
        def loss_fn(p):
            return JT.lm_loss(JCFG, p, batch["inputs"], batch["labels"], impl="xla",
                              compute_dtype=jnp.float32)

        (loss, m), g = jax.value_and_grad(loss_fn, has_aux=True)(state["params"])
        g, gnorm = jclip(g, jtcfg.grad_clip_norm)
        lr = sched(state["opt"]["step"])
        new_p, new_opt = jadamw_update(g, state["opt"], state["params"], lr=lr, cfg=jtcfg)
        return {"params": new_p, "opt": new_opt}, {"loss": loss, "ce": m["ce"],
                                                   "grad_norm": gnorm, "lr": lr}

    jparams = jax.tree.map(jnp.asarray, NP_PARAMS)
    jstate = {"params": jparams, "opt": jadamw_init(jparams)}
    step = make_train_step(CFG, TrainConfig(**TRAIN_KW), device="cpu")
    state = init_train_state(params_from_numpy(NP_PARAMS, device="cpu"))
    jds = JDataset(JCFG, seq_len=24, global_batch=4, seed=7)
    tds = SyntheticDataset(CFG, seq_len=24, global_batch=4, seed=7)
    for _ in range(3):
        jb, tb = jds.next_batch(), tds.next_batch()
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jb.items()})
        state, m = step(state, tb)
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5)
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]), rtol=1e-7)
    tflat = _flat(state["params"])
    for name, ref in _flat(jstate["params"]).items():
        np.testing.assert_allclose(tflat[name], ref, rtol=0, atol=2e-6, err_msg=name)
