"""Port training path against the reference, on the CPU in fp32.

* ``lm_loss`` and its gradients against ``jax.value_and_grad`` of the
  reference's ``lm_loss`` (``impl="xla"``; the Pallas flash kernel has no
  VJP) on the qwen3-1.7b and olmo-1b smoke configs.  Tolerances: loss
  |d| <= 1e-5; each gradient max|d| <= 1e-4 * max|g| (fp32, sums in
  another order).
* Three train steps of ``make_train_step`` against the same composition of
  ``repro.optim`` (``clip_by_global_norm``, ``make_schedule``,
  ``adamw_update``) jitted around the reference's loss (the reference's own
  ``make_train_step`` needs a mesh that fails on this JAX).  Losses and
  grad norms within 1e-5 relative, lr exact to fp32 rounding (1e-7
  relative), params within 2e-6 absolute: an AdamW step moves a weight by
  lr * mu_hat / (sqrt(nu_hat) + eps), and where a gradient is near eps its
  1e-6 relative difference moves that ratio by up to ~1e-4 of lr (1e-2).
* ``SyntheticDataset`` batches equal to the reference's, and the optimizer
  pieces against ``repro.optim`` one by one.

Weights go through ``bridge.params_from_numpy``; inputs come from numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro.optim import make_schedule as jmake_schedule
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import TrainConfig
from repro_torch.data import SyntheticDataset
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, make_schedule
from repro_torch.runtime import init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ARCHS = ("qwen3-1.7b", "olmo-1b")
SEQ, BATCH = 24, 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _setup(arch, seed=0):
    jcfg = jconfigs.smoke_config(arch)
    cfg = configs.smoke_config(arch)
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, cfg, np_params


def _batch(vocab, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _check_loss_and_grads(arch, remat_policy):
    """The port's ``lm_loss`` and gradients against ``jax.value_and_grad`` of
    the reference's, both under ``remat_policy``."""
    jcfg, cfg, np_params = _setup(arch)
    inputs, labels = _batch(cfg.vocab_size)

    def jloss(p):
        return JT.lm_loss(jcfg, p, jnp.asarray(inputs), jnp.asarray(labels),
                          impl="xla", remat_policy=remat_policy,
                          compute_dtype=jnp.float32)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, np_params)
    )
    params = params_from_numpy(np_params, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, metrics = T.lm_loss(cfg, params, torch.from_numpy(inputs),
                              torch.from_numpy(labels), remat_policy=remat_policy,
                              compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert abs(loss.item() - float(jl)) <= 1e-5
    assert abs(metrics["ce"].item() - float(jm["ce"])) <= 1e-5
    tg = _flat(tree_unflatten(params, list(grads)))
    jflat = _flat(jg)
    assert tg.keys() == jflat.keys()
    for name, ref in jflat.items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(tg[name] - ref).max())
        assert err <= 1e-4 * max(scale, 1e-12), (name, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    _check_loss_and_grads(arch, "none")


def test_dots_remat_loss_and_grads_match_reference():
    _check_loss_and_grads("qwen3-1.7b", "dots")


def test_forward_logits_match_reference():
    jcfg, cfg, np_params = _setup("qwen3-1.7b", seed=2)
    inputs, _ = _batch(cfg.vocab_size, seed=3)
    jlogits, _ = JT.forward(jcfg, jax.tree.map(jnp.asarray, np_params),
                            jnp.asarray(inputs), impl="xla", compute_dtype=jnp.float32)
    logits, metrics = T.forward(cfg, params_from_numpy(np_params, device="cpu"),
                                torch.from_numpy(inputs), compute_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    assert float(metrics["moe_aux"]) == 0.0


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_no_remat(policy):
    _, cfg, np_params = _setup("qwen3-1.7b")
    inputs, labels = (torch.from_numpy(a) for a in _batch(cfg.vocab_size))
    out = {}
    for name in ("none", policy):
        params = params_from_numpy(np_params, device="cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, _ = T.lm_loss(cfg, params, inputs, labels, remat_policy=name,
                            compute_dtype=torch.float32)
        out[name] = (loss, torch.autograd.grad(loss, tree_leaves(params)))
    assert torch.equal(out["none"][0], out[policy][0])
    for a, b in zip(out["none"][1], out[policy][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="remat_policy"):
        T.forward(cfg, params_from_numpy(np_params, device="cpu"), inputs,
                  remat_policy="offload")


# ---------------------------------------------------------------------------
# optimizer pieces and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(schedule):
    kw = dict(learning_rate=3e-3, warmup_steps=4, total_steps=20, schedule=schedule)
    jsched, tsched = jmake_schedule(JTrainConfig(**kw)), make_schedule(TrainConfig(**kw))
    for step in (0, 1, 3, 4, 5, 11, 20, 30):
        np.testing.assert_allclose(
            tsched(torch.tensor(step, dtype=torch.int32)).item(),
            float(jsched(jnp.int32(step))), rtol=1e-7,
        )


def test_clip_and_adamw_match_reference():
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    grads = tree_map(lambda a: (a * 3.0).astype(np.float32), tree)
    kw = dict(learning_rate=1e-2, weight_decay=0.1)
    jcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jg, jnorm = jclip(jax.tree.map(jnp.asarray, grads), 1.0)
    tg, tnorm = clip_by_global_norm(params_from_numpy(grads, device="cpu"), 1.0)
    np.testing.assert_allclose(tnorm.item(), float(jnorm), rtol=1e-6)
    jp = jax.tree.map(jnp.asarray, tree)
    jopt = jadamw_init(jp)
    tp = params_from_numpy(tree, device="cpu")
    topt = adamw_init(tp)
    for _ in range(2):
        jp, jopt = jadamw_update(jg, jopt, jp, lr=1e-2, cfg=jcfg)
        tp, topt = adamw_update(tg, topt, tp, lr=1e-2, cfg=tcfg)
    assert int(topt["step"]) == int(jopt["step"]) == 2
    for name, ref in _flat(jp).items():
        np.testing.assert_allclose(_flat(tp)[name], ref, rtol=0, atol=1e-7)
    for name, ref in _flat(jopt["nu"]).items():
        np.testing.assert_allclose(_flat(topt["nu"])[name], ref, rtol=1e-6)


def test_synthetic_dataset_batches_equal_reference():
    jcfg, cfg = jconfigs.smoke_config("qwen3-1.7b"), configs.smoke_config("qwen3-1.7b")
    jds = JDataset(jcfg, seq_len=16, global_batch=4, seed=3)
    tds = SyntheticDataset(cfg, seq_len=16, global_batch=4, seed=3)
    for _ in range(3):
        jb, tb = jds.next_batch(), tds.next_batch()
        assert tb.keys() == jb.keys()
        for key in jb:
            assert tb[key].dtype == jb[key].dtype
            np.testing.assert_array_equal(tb[key], jb[key])


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

TRAIN_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                compute_dtype="float32")


def _jax_train_step(jcfg, jtcfg):
    """The reference's train-step composition, without its mesh."""
    sched = jmake_schedule(jtcfg)

    @jax.jit
    def step(state, batch):
        def loss_fn(p):
            return JT.lm_loss(jcfg, p, batch["inputs"], batch["labels"],
                              impl="xla", compute_dtype=jnp.float32)

        (loss, m), g = jax.value_and_grad(loss_fn, has_aux=True)(state["params"])
        g = jax.tree.map(lambda x: x.astype(jnp.float32), g)
        g, gnorm = jclip(g, jtcfg.grad_clip_norm)
        lr = sched(state["opt"]["step"])
        new_p, new_opt = jadamw_update(g, state["opt"], state["params"], lr=lr, cfg=jtcfg)
        return {"params": new_p, "opt": new_opt}, {
            "loss": loss, "ce": m["ce"], "moe_aux": m["moe_aux"],
            "grad_norm": gnorm, "lr": lr,
        }

    return step


def test_three_train_steps_match_reference_composition():
    jcfg, cfg, np_params = _setup("qwen3-1.7b", seed=4)
    jstep = _jax_train_step(jcfg, JTrainConfig(**TRAIN_KW))
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = {"params": jparams, "opt": jadamw_init(jparams)}
    step = make_train_step(cfg, TrainConfig(**TRAIN_KW), device="cpu")
    state = init_train_state(params_from_numpy(np_params, device="cpu"))
    jds = JDataset(jcfg, seq_len=SEQ, global_batch=4, seed=7)
    tds = SyntheticDataset(cfg, seq_len=SEQ, global_batch=4, seed=7)
    for _ in range(3):
        jb, tb = jds.next_batch(), tds.next_batch()
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in jb.items()})
        state, m = step(state, tb)
        assert m.keys() == jm.keys()
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5)
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]), rtol=1e-7)
        assert m["moe_aux"].item() == float(jm["moe_aux"]) == 0.0
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 3
    tflat = _flat(state["params"])
    for name, ref in _flat(jstate["params"]).items():
        np.testing.assert_allclose(tflat[name], ref, rtol=0, atol=2e-6, err_msg=name)


def test_microbatched_step_matches_one_batch():
    _, cfg, np_params = _setup("olmo-1b")
    batch = SyntheticDataset(cfg, seq_len=SEQ, global_batch=4, seed=2).next_batch()
    results = []
    for micro in (1, 2):
        tcfg = TrainConfig(**dict(TRAIN_KW, warmup_steps=0), microbatches=micro)
        step = make_train_step(cfg, tcfg, device="cpu")
        state, m = step(init_train_state(params_from_numpy(np_params, device="cpu")), batch)
        results.append((m, _flat(state["params"])))
    (m1, p1), (m2, p2) = results
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(m2[key].item(), m1[key].item(), rtol=1e-5)
    for name, ref in p1.items():
        np.testing.assert_allclose(p2[name], ref, rtol=0, atol=2e-6, err_msg=name)


def test_train_step_refuses_what_is_not_ported():
    cfg = configs.smoke_config("qwen3-1.7b")
    with pytest.raises(NotImplementedError, match="powersgd"):
        make_train_step(cfg, TrainConfig(grad_compression="powersgd"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_train_step(cfg, TrainConfig())


def test_train_config_fields_match_reference():
    """Every field of the reference's, in its order and with its default,
    the mesh layout (``zero1``, ``fsdp``, ``layout``) included."""
    jf = {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert tf == {k: v for k, v in jf.items() if k in tf}
    assert list(tf) == list(jf)
