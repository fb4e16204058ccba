"""int8 error-feedback gradient compression against the reference, on the
CPU in fp32.

* ``_quantize`` and ``ef_int8_compress_decompress`` bit-equal to
  ``repro.optim.compression``'s on seeded arrays with zeros, an all-zero
  leaf and exact half-way values of ``g / scale`` (both round half to
  even); the EF identity ``deq + err_new == g + err_old`` holds exactly.
* Three ``grad_compression="int8_ef"`` train steps of ``make_train_step``
  against the reference's step composition (``repro/runtime/step.py``: the
  dequantized gradient replaces the gradient before the clip) around
  ``jax.value_and_grad`` of the reference's ``lm_loss``.  The quantizer
  jumps by one quantum (max |g| / 127) at every half-way point, and
  gradients that differ by sums in another order (~1e-6 relative) land on
  either side of one for about 1 element in 10^5 (1 of 90,496 at this
  test's second step); Adam turns such a flip into a ~1e-3 parameter
  difference.  So every step starts both sides from the port's state:
  the port's gradient (recorded where the step hands it to the quantizer)
  is held to ``jax.value_and_grad`` at ``tests/test_torch_train.py``'s
  gradient tolerance (each leaf within 1e-4 of its largest |g|; loss 1e-5
  relative), and the reference's EF, clip and AdamW applied to that same
  gradient are held to the port's new state at that file's step
  tolerances: grad norm 1e-5 relative, lr 1e-7 relative, params 2e-6
  absolute; the moments within 1e-5 of the leaf's largest value (the
  clip's norm sums in another order, and nu squares it); the error
  buffers within one ulp of the leaf's largest |g| (XLA fuses
  ``g32 - q * scale`` into one multiply-add in the jitted step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import transformer as JT
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro.optim import ef_int8_compress_decompress as jef
from repro.optim import make_schedule as jmake_schedule
from repro.optim.compression import _quantize as jquantize
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import TrainConfig
from repro_torch.data import SyntheticDataset
from repro_torch.optim import ef_int8_compress_decompress
from repro_torch.optim.compression import _quantize
from repro_torch.runtime import init_train_state, make_train_step
from repro_torch.runtime import step as step_module
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


TIES = (127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5, 0.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cases():
    """Seeded leaves, all [64, 64] (the reference compiles each op once a
    shape)."""
    rng = np.random.default_rng(0)
    shape = (64, 64)
    g = rng.standard_normal(shape).astype(np.float32)
    g.flat[::7] = 0.0
    err = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    # max |g| = 127: scale is exactly 1, so every x.5 is a tie of g / scale
    ties = np.resize(np.array(TIES, np.float32), shape)
    halves = (rng.integers(-254, 255, shape) / 2).astype(np.float32)
    halves.flat[0] = 127.0
    big = (rng.standard_normal(shape) * 1e3).astype(np.float32)
    zeros = np.zeros(shape, np.float32)
    return {
        "random_with_zeros": (g, err),
        "all_zero": (zeros, zeros),
        "exact_ties": (ties, zeros),
        "half_steps": (halves, zeros),
        "large_with_err": (big, rng.standard_normal(shape).astype(np.float32)),
    }


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_ef_int8_bit_equal_to_reference(case):
    g, err = CASES[case]
    jdeq, jerr = jef(jnp.asarray(g), jnp.asarray(err))
    deq, new_err = ef_int8_compress_decompress(torch.from_numpy(g), torch.from_numpy(err))
    assert deq.dtype == new_err.dtype == torch.float32
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(jerr))
    g32 = torch.from_numpy(g) + torch.from_numpy(err)
    assert torch.equal(deq + new_err, g32)  # the EF identity, exactly
    jq, jscale = jquantize(jnp.asarray(g + err))
    q, scale = _quantize(g32)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.item() == float(jscale)


def test_ties_round_half_to_even():
    g, _ = CASES["exact_ties"]
    q, scale = _quantize(torch.from_numpy(g))
    assert scale.item() == 1.0
    assert q.flatten()[:len(TIES)].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 4, 0]


TRAIN_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                compute_dtype="float32", grad_compression="int8_ef")
SEQ = 16


def _reference_pieces(jcfg, jtcfg):
    """The reference's loss gradient, and its int8_ef update (EF, clip,
    schedule, AdamW: ``repro/runtime/step.py``) of a given gradient."""
    sched = jmake_schedule(jtcfg)

    @jax.jit
    def grads(params, batch):
        def loss_fn(p):
            return JT.lm_loss(jcfg, p, batch["inputs"], batch["labels"],
                              impl="xla", compute_dtype=jnp.float32)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    @jax.jit
    def update(state, g):
        pairs = jax.tree.map(jef, g, state["err"])
        is_pair = lambda t: isinstance(t, tuple)  # noqa: E731
        g = jax.tree.map(lambda t: t[0], pairs, is_leaf=is_pair)
        new_err = jax.tree.map(lambda t: t[1], pairs, is_leaf=is_pair)
        g, gnorm = jclip(g, jtcfg.grad_clip_norm)
        lr = sched(state["opt"]["step"])
        new_p, new_opt = jadamw_update(g, state["opt"], state["params"], lr=lr, cfg=jtcfg)
        return {"params": new_p, "opt": new_opt, "err": new_err}, gnorm, lr

    return grads, update


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _paths(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_three_int8_ef_train_steps_match_reference_composition(monkeypatch):
    jcfg, cfg = jconfigs.smoke_config("qwen3-1.7b"), configs.smoke_config("qwen3-1.7b")
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(4)))
    tcfg = TrainConfig(**TRAIN_KW)
    ref_grads, ref_update = _reference_pieces(jcfg, JTrainConfig(**TRAIN_KW))
    step = make_train_step(cfg, tcfg, device="cpu")
    state = init_train_state(params_from_numpy(np_params, device="cpu"), tcfg)
    seen = []

    def recording_ef(g, err):
        seen.append(g.clone())
        return ef_int8_compress_decompress(g, err)

    monkeypatch.setattr(step_module, "ef_int8_compress_decompress", recording_ef)
    tds = SyntheticDataset(cfg, seq_len=SEQ, global_batch=2, seed=7)
    for _ in range(3):
        before = _np(state)
        batch = tds.next_batch()
        seen.clear()
        state, m = step(state, batch)
        # the port's gradient against the reference's at the same params
        (jl, jm), jg = ref_grads(jax.tree.map(jnp.asarray, before["params"]),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
        np.testing.assert_allclose(m["loss"].item(), float(jl), rtol=1e-5)
        np.testing.assert_allclose(m["ce"].item(), float(jm["ce"]), rtol=1e-5)
        grads = _np(tree_unflatten(state["params"], seen))
        jflat = _paths(jg)
        for name, g in _paths(grads).items():
            scale = float(np.abs(jflat[name]).max())
            err = float(np.abs(g - jflat[name]).max())
            assert err <= 1e-4 * max(scale, 1e-12), (name, err, scale)
        # the reference's EF + clip + AdamW on that same gradient
        jstate, jnorm, jlr = ref_update(jax.tree.map(jnp.asarray, before),
                                        jax.tree.map(jnp.asarray, grads))
        np.testing.assert_allclose(m["grad_norm"].item(), float(jnorm), rtol=1e-5)
        np.testing.assert_allclose(m["lr"].item(), float(jlr), rtol=1e-7)
        assert int(state["opt"]["step"]) == int(jstate["opt"]["step"])
        tflat, jflat = _paths(_np(state)), _paths(jstate)
        assert tflat.keys() == jflat.keys()
        g32 = _paths(tree_map(np.add, grads, before["err"]))
        for name, ref in jflat.items():
            if name.startswith("err/"):
                # XLA contracts g32 - q * scale into one fused multiply-add
                # inside the jitted step; the port (and the reference's
                # function called on its own) rounds q * scale first: one
                # ulp of the leaf's largest value
                atol = 2.0**-23 * float(np.abs(g32[name[len("err/"):]]).max())
                np.testing.assert_allclose(tflat[name], ref, rtol=0, atol=atol, err_msg=name)
            elif name.startswith("params/"):
                np.testing.assert_allclose(tflat[name], ref, rtol=0, atol=2e-6, err_msg=name)
            else:
                atol = 1e-5 * float(np.abs(ref).max())
                np.testing.assert_allclose(tflat[name], ref, rtol=0, atol=atol, err_msg=name)
    assert int(state["opt"]["step"]) == 3


def test_init_train_state_adds_error_buffers_for_int8_ef():
    cfg = configs.smoke_config("olmo-1b")
    params = params_from_numpy(jax.tree.map(np.array, JT.init_params(
        jconfigs.smoke_config("olmo-1b"), jax.random.PRNGKey(0))), device="cpu")
    assert "err" not in init_train_state(params)
    assert "err" not in init_train_state(params, TrainConfig())
    state = init_train_state(params, TrainConfig(grad_compression="int8_ef"))
    for e, p in zip(tree_leaves(state["err"]), tree_leaves(state["params"])):
        assert e.dtype == torch.float32 and e.shape == p.shape and not e.any()
        assert not e.requires_grad
    step = make_train_step(cfg, TrainConfig(grad_compression="int8_ef"), device="cpu")
    batch = SyntheticDataset(cfg, seq_len=8, global_batch=2).next_batch()
    with pytest.raises(ValueError, match="init_train_state"):
        step(init_train_state(params), batch)
