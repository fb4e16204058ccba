"""The fused collocated step (``repro_torch.core.make_collocated_step``) and
``pick_bucket``, on the CPU, against the reference's
(``tests/test_filling_system.py``'s fused-step test, on the same weights
through ``params_from_numpy``).

* ``fused[k]`` for k in {0, 2}: the train step's loss, AdamW moments and
  new parameters equal the reference's fused program's (fp32; the
  parameters at ``test_torch_train.py``'s tolerance, where the gradient is
  not within rounding of zero), the k-step tokens and cache equal its
  decode chain's, and the train result is bit-equal across k and to the
  train step run alone.
* Over a one-rank gloo group the fused step runs a ``ShardedTrainStep``
  (FSDP, ZeRO-1) unchanged: bit-equal to the sharded step alone, the
  tokens equal to k eager ``decode_step`` calls.  The multi-rank case is
  in ``test_torch_dist_step.py``.
* ``pick_bucket`` equals the reference's on its cases and over a grid.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import make_collocated_step as jmake_collocated_step
from repro.core import pick_bucket as jpick_bucket
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import TrainConfig
from repro_torch.core import make_collocated_step, pick_bucket
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.runtime import make_train_step
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ARCH = "olmo-1b"
LR = 1e-2
SLOTS, MAX_SEQ, START = 2, 32, (5, 9)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jconfigs.smoke_config(ARCH), configs.smoke_config(ARCH)
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = JDataset(jcfg, seq_len=32, global_batch=4).next_batch()
    rng = np.random.default_rng(3)
    shape = JT.init_cache(jcfg, SLOTS, MAX_SEQ, jnp.float32)["layers"]["k"].shape
    kv = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    return jcfg, cfg, np_params, batch, kv


def _jax_fused(jcfg, np_params, batch, kv, k):
    tcfg = JTrainConfig(learning_rate=LR)

    def train_step(state, batch):
        def loss_fn(p):
            loss, _ = JT.lm_loss(jcfg, p, batch["inputs"], batch["labels"], impl="xla",
                                 compute_dtype=jnp.float32)
            return loss

        loss, g = jax.value_and_grad(loss_fn)(state["params"])
        g = jax.tree.map(lambda x: x.astype(jnp.float32), g)
        new_p, new_opt = jadamw_update(g, state["opt"], state["params"], lr=LR, cfg=tcfg)
        return {"params": new_p, "opt": new_opt}, {"loss": loss}

    def decode_fn(p, tokens, cache):
        return JT.decode_step(jcfg, p, tokens, cache, compute_dtype=jnp.float32,
                              attn_impl="xla")

    fused = jmake_collocated_step(train_step, decode_fn, k_buckets=(k,))[k]
    params = jax.tree.map(jnp.asarray, np_params)
    # the program donates the train state and the cache: copies
    state = jax.tree.map(jnp.copy, {"params": params, "opt": jadamw_init(params)})
    cache = {"index": jnp.asarray(START, jnp.int32),
             "layers": {n: jnp.asarray(v) for n, v in kv.items()}}
    b = {n: jnp.asarray(v) for n, v in batch.items()}
    new_state, m, toks, cache = fused(state, b, params, jnp.asarray([1, 2], jnp.int32), cache)
    return new_state, m, toks, cache


def _torch_train_step(cfg):
    tcfg = TrainConfig(learning_rate=LR)

    def train_step(state, batch):
        loss, _ = T.lm_loss(cfg, state["params"], torch.as_tensor(batch["inputs"]),
                            torch.as_tensor(batch["labels"]), compute_dtype=torch.float32)
        grads = torch.autograd.grad(loss, tree_leaves(state["params"]))
        g = tree_unflatten(state["params"], [x.float() for x in grads])
        adamw_update(g, state["opt"], state["params"], lr=LR, cfg=tcfg)
        return state, {"loss": loss.detach()}

    return train_step


def _decode_fn(cfg):
    def decode_fn(p, tokens, cache):
        return T.decode_step(cfg, p, tokens, cache, compute_dtype=torch.float32,
                             attn_impl="torch")

    return decode_fn


def _torch_inputs(np_params, kv):
    params = params_from_numpy(np_params, device="cpu")
    own = tree_map(lambda p: p.clone().requires_grad_(True), params)
    state = {"params": own, "opt": adamw_init(own)}
    cache = {"index": torch.tensor(START, dtype=torch.int32),
             "layers": {n: torch.tensor(v) for n, v in kv.items()}}
    return params, state, cache


@pytest.mark.parametrize("k", [0, 2])
def test_fused_step_matches_reference(setup, k):
    jcfg, cfg, np_params, batch, kv = setup
    j_state, jm, j_toks, j_cache = _jax_fused(jcfg, np_params, batch, kv, k)

    train_step = _torch_train_step(cfg)
    fused = make_collocated_step(train_step, _decode_fn(cfg), k_buckets=(0, k))
    params, state, cache = _torch_inputs(np_params, kv)
    state, m, toks, cache = fused[k](state, batch, params, torch.tensor([1, 2], dtype=torch.int32),
                                     cache)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    for name in ("mu", "nu"):  # (1 - beta) g and (1 - beta2) g^2
        for a, b in zip(tree_leaves(state["opt"][name]), jax.tree.leaves(j_state["opt"][name])):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())
    # AdamW's first step moves a weight by ~lr * g / (|g| + eps): where |g| is
    # within the two gradients' rounding of zero the step's size differs, so
    # the weights are held where |g| >= 1e-4 max |g|
    for a, b, mu in zip(tree_leaves(state["params"]), jax.tree.leaves(j_state["params"]),
                        jax.tree.leaves(j_state["opt"]["mu"])):
        mu = np.abs(np.asarray(mu))
        held = mu >= 1e-4 * mu.max()
        assert held.mean() > 0.99
        np.testing.assert_allclose(a.detach().numpy()[held], np.asarray(b)[held], rtol=0,
                                   atol=2e-6)
    assert toks.tolist() == np.asarray(j_toks).tolist()
    assert cache["index"].tolist() == np.asarray(j_cache["index"]).tolist() == [
        s + k for s in START]
    for n in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][n].numpy(), np.asarray(j_cache["layers"][n]),
                                   rtol=0, atol=1e-5)

    # the train result does not depend on k, and equals the step alone
    _, alone, _ = _torch_inputs(np_params, kv)
    alone, m_alone = train_step(alone, batch)
    assert torch.equal(m["loss"], m_alone["loss"])
    for a, b in zip(tree_leaves(state), tree_leaves(alone)):
        assert torch.equal(a.detach(), b.detach())


def test_fused_step_runs_a_sharded_step_unchanged(setup, tmp_path):
    _, cfg, np_params, batch, kv = setup
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        tcfg = TrainConfig(learning_rate=LR, fsdp=True, zero1=True)
        step = make_train_step(cfg, tcfg, make_dev_mesh(device="cpu"), device="cpu")
        fused = make_collocated_step(step, _decode_fn(cfg), k_buckets=(0, 2))
        params = params_from_numpy(np_params, device="cpu")
        results = {}
        for k in (0, 2):
            _, _, cache = _torch_inputs(np_params, kv)
            state = step.init_state(params)
            state, m, toks, cache = fused[k](state, step.shard_batch(batch), params,
                                             torch.tensor([1, 2], dtype=torch.int32), cache)
            results[k] = (state, m, toks)
        state = step.init_state(params)
        state, m = step(state, step.shard_batch(batch))
        for k, (s_k, m_k, _) in results.items():
            for key in m:
                assert torch.equal(m_k[key], m[key]), (k, key)
            for a, b in zip(tree_leaves(s_k), tree_leaves(state)):
                assert torch.equal(a.detach(), b.detach()), k
        # the chain: two eager decode steps, argmax fed back
        _, _, cache = _torch_inputs(np_params, kv)
        toks = torch.tensor([1, 2], dtype=torch.int32)
        for _ in range(2):
            logits, cache = _decode_fn(cfg)(params, toks, cache)
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
        assert results[2][2].tolist() == toks.tolist()
        assert results[0][2].tolist() == [1, 2]
    finally:
        dist.destroy_process_group()


def test_pick_bucket_matches_reference():
    # the reference test's cases
    assert pick_bucket(0.0, 1.0) == 0
    assert pick_bucket(3.0, 1.0) == 2
    assert pick_bucket(8.0, 1.0) == 8
    assert pick_bucket(7.9, 1.0) == 4
    assert pick_bucket(100.0, 12.0) == 8
    for tokens in np.linspace(0.0, 40.0, 81):
        for micro in (0.0, 0.5, 1.0, 3.0, 12.0):
            for buckets in ((0, 1, 2, 4, 8), (1, 2, 4), (0, 3, 5)):
                assert pick_bucket(tokens, micro, buckets) == jpick_bucket(tokens, micro, buckets)
