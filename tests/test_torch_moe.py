"""Port Mixture-of-Experts family against the reference, on the CPU in fp32.

* The four configs the slice adds are registered; every config and smoke
  config has the reference's fields and parameter counts, and
  ``param_count`` counts the tree ``init_params`` builds.
* ``moe_block`` against ``repro.models.moe.moe_block`` on the reference's
  weights (bridged) and the same numpy inputs: decode (``B > 1, S == 1``,
  one routing group), per-row groups (``B = 1, S = 1`` and ``B, S > 1``), a
  capacity factor that drops choices, a batch large enough that decode
  drops, and a router rounded to bf16 against fp32 activations.  ``y``,
  ``aux`` and ``dropped`` agree to 1e-5 (fp32, sums in another order); the
  chosen experts are equal.
* ``forward``, ``lm_loss`` and every gradient against
  ``jax.value_and_grad`` of the reference's ``lm_loss`` for moonshot-smoke
  and dbrx-smoke under remat ``"none"`` and ``"dots"``: loss and ``moe_aux``
  |d| <= 1e-5, ``moe_dropped`` equal, each gradient max|d| <= 1e-4 *
  max|g|.  Under ``"dots"`` the port saves the outputs the reference's
  policy saves (the projections and the router, not the experts' batched
  products).
* ``forward``'s logits and ``moe_aux`` against the reference's.
* ``paged_kv_write``, the K/V write of every attention family: rows that
  land on one pool row (idle slots on the sentinel page, a chunk past its
  slot's pages) leave the reference's value, every time, in the K pool and
  the V pool written from one resolution.
"""
import contextlib
import dataclasses
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.ad_checkpoint import print_saved_residuals
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_unflatten

NEW_ARCHS = ("qwen2-7b", "deepseek-coder-33b", "moonshot-v1-16b-a3b", "dbrx-132b")
MOE_ARCHS = ("moonshot-v1-16b-a3b", "dbrx-132b")
ATOL = 1e-5
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
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _batch(vocab, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_config_and_smoke_config_match_reference(arch):
    for full in (False, True):
        got = configs.get_config(arch) if full else configs.smoke_config(arch)
        ref = jconfigs.get_config(arch) if full else jconfigs.smoke_config(arch)
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(ref, f.name), f.name
        assert got.param_count() == ref.param_count()
        assert got.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_count_counts_the_init_tree(arch):
    cfg = configs.smoke_config(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in tree_leaves(params)) == cfg.param_count()
    if cfg.family == "moe":
        assert params["layers"]["ffn"]["router"].dtype == torch.float32
        assert cfg.active_param_count() < cfg.param_count()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "moonshot-v1-16b-a3b"])
def test_init_params_draw_order(arch):
    """The seeded init draws the embedding, then each layer's attention
    before its MLP or experts, then the head: the card's runs of earlier
    PRs keep their weights."""
    cfg = configs.smoke_config(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(0)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen) * cfg.d_model**-0.5
    torch.testing.assert_close(params["embed"], embed, rtol=0, atol=0)
    for i in range(cfg.num_layers):
        attn = L.init_attention(cfg, gen, cfg.d_model, torch.float32)
        ffn = (M.init_moe(cfg, gen, torch.float32) if cfg.family == "moe"
               else L.init_mlp(gen, cfg.d_model, cfg.d_ff, torch.float32))
        for name, tree in (("attn", attn), ("ffn", ffn)):
            for k, v in tree.items():
                torch.testing.assert_close(params["layers"][name][k][i], v, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------


def _moe_inputs(cfg, jcfg, b, s, seed, shared=0.0):
    """Reference MoE weights and tokens; ``shared`` adds one common
    direction to every token, which skews the routing toward a few
    experts."""
    np_p = jax.tree.map(np.array, JM.init_moe(jcfg, jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)) + shared * rng.standard_normal(cfg.d_model)
    return np_p, x.astype(np.float32)


def _reference_ids(jcfg, p, x):
    """The experts the reference routes each token to (``moe.py``'s router
    einsum and top-k over the same group layout)."""
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x, jnp.float32), p["router"])
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.experts_per_token)[1])


MOE_CASES = {
    # name: (B, S, capacity factor, shared direction, drops expected)
    "decode_one_group": (6, 1, 1.25, 0.0, False),
    "decode_b1_per_row": (1, 1, 1.25, 0.0, False),
    "prefill_per_row": (3, 20, 1.25, 0.0, False),
    "capacity_drops": (3, 40, 0.25, 0.0, True),
    # 12 tokens, 24 choices, 8 slots an expert: skewed routing overflows
    "decode_drops_across_slots": (12, 1, 1.25, 5.0, True),
}


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_matches_reference(arch, case):
    b, s, cf, shared, drops = MOE_CASES[case]
    cfg = dataclasses.replace(configs.smoke_config(arch), moe_capacity_factor=cf)
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), moe_capacity_factor=cf)
    np_p, x = _moe_inputs(cfg, jcfg, b, s, seed=len(case), shared=shared)
    jp = jax.tree.map(jnp.asarray, np_p)
    jy, jaux, jdrop = JM.moe_block(jcfg, jp, jnp.asarray(x))
    tp = params_from_numpy(np_p, device="cpu")
    y, aux, dropped = M.moe_block(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    assert abs(aux.item() - float(jaux)) <= ATOL
    assert abs(dropped.item() - float(jdrop)) <= ATOL
    assert (dropped.item() > 0) == drops
    groups, capacity = M.routing_groups(cfg, torch.from_numpy(x))
    _, _, _, ids = M.route(cfg, tp, groups, capacity)
    np.testing.assert_array_equal(ids.reshape(b, s, -1).numpy(), _reference_ids(jcfg, jp, x))


def test_routing_in_fp32_against_a_bf16_router():
    """A step casts the fp32 router to bf16; the fp32 activations then meet
    the rounded router in fp32 (the reference's type promotion)."""
    cfg, jcfg = configs.smoke_config("moonshot-v1-16b-a3b"), jconfigs.smoke_config(
        "moonshot-v1-16b-a3b")
    np_p, x = _moe_inputs(cfg, jcfg, 4, 8, seed=7)
    jp = jax.tree.map(jnp.asarray, np_p)
    jp["router"] = jp["router"].astype(jnp.bfloat16)
    jy, jaux, _ = JM.moe_block(jcfg, jp, jnp.asarray(x))
    tp = params_from_numpy(np_p, device="cpu")
    tp["router"] = tp["router"].to(torch.bfloat16)
    y, aux, _ = M.moe_block(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    assert abs(aux.item() - float(jaux)) <= ATOL


def test_new_archs_registered():
    assert set(NEW_ARCHS) <= set(configs.ARCH_IDS)


def test_expert_capacity_matches_reference():
    cfg, jcfg = configs.get_config("moonshot-v1-16b-a3b"), jconfigs.get_config(
        "moonshot-v1-16b-a3b")
    for n in (1, 8, 32, 33, 1024, 4096):
        assert M.expert_capacity(cfg, n) == JM.expert_capacity(jcfg, n)


# ---------------------------------------------------------------------------
# forward, lm_loss, gradients, remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat_policy", ["none", "dots"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_loss_and_grads_match_reference(arch, remat_policy):
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    inputs, labels = _batch(cfg.vocab_size)

    def jloss(p):
        return JT.lm_loss(jcfg, p, jnp.asarray(inputs), jnp.asarray(labels),
                          impl="xla", remat_policy=remat_policy,
                          compute_dtype=jnp.float32)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, np_params))
    params = params_from_numpy(np_params, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, metrics = T.lm_loss(cfg, params, torch.from_numpy(inputs),
                              torch.from_numpy(labels), remat_policy=remat_policy,
                              compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert abs(loss.item() - float(jl)) <= ATOL
    assert abs(metrics["ce"].item() - float(jm["ce"])) <= ATOL
    assert abs(metrics["moe_aux"].item() - float(jm["moe_aux"])) <= ATOL
    assert metrics["moe_aux"].item() > 0
    assert metrics["moe_dropped"].item() == pytest.approx(float(jm["moe_dropped"]), abs=1e-7)
    tg = _flat(tree_unflatten(params, list(grads)))
    jflat = _flat(jg)
    assert tg.keys() == jflat.keys()
    for name, ref in jflat.items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(tg[name] - ref).max())
        assert err <= 1e-4 * max(scale, 1e-12), (name, err, scale)
    assert np.abs(tg["layers/ffn/router"]).max() > 0


def test_dots_saves_what_the_reference_saves():
    """One MoE layer under ``"dots"``: the element counts of the outputs the
    port's policy saves equal those of the residuals the reference's
    ``checkpoint_dots_with_no_batch_dims`` saves (the q / k / v and output
    projections and the router product; the experts' products carry the
    expert dimension as a batch dimension and are recomputed)."""
    arch = "moonshot-v1-16b-a3b"
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    np_layer = jax.tree.map(lambda a: a[0], np_params["layers"])
    h = np.random.default_rng(0).standard_normal((2, 16, cfg.d_model)).astype(np.float32)

    def jlayer(lp, x):
        return JT._dense_layer(jcfg, lp, x, "xla")[0].sum()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print_saved_residuals(
            jax.checkpoint(jlayer,
                           policy=jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims),
            jax.tree.map(jnp.asarray, np_layer), jnp.asarray(h))
    ref = sorted(int(np.prod([int(n) for n in dims.split(",")]))
                 for dims in re.findall(r"f32\[([\d,]+)\] output of", out.getvalue()))

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.saved = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if T._save_dots(None, func) == CheckpointPolicy.MUST_SAVE:
                self.saved.append(out.numel())
            return out

    rec = Record()
    with rec:
        T._dense_layer(cfg, params_from_numpy(np_layer, device="cpu"), torch.from_numpy(h), "torch")
    assert sorted(rec.saved) == ref
    assert len(ref) == 5


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(2)))
    inputs, _ = _batch(cfg.vocab_size, seed=3)
    jlogits, jm = JT.forward(jcfg, jax.tree.map(jnp.asarray, np_params),
                             jnp.asarray(inputs), impl="xla", compute_dtype=jnp.float32)
    logits, metrics = T.forward(cfg, params_from_numpy(np_params, device="cpu"),
                                torch.from_numpy(inputs), compute_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=ATOL)
    assert abs(metrics["moe_aux"].item() - float(jm["moe_aux"])) <= ATOL


def test_paged_kv_write_last_wins_matches_reference():
    """Three idle slots on the sentinel page at index 0 and a 64-row chunk
    running past its slot's two pages: every collision resolves to the
    reference's (the last row in row-major order), over 20 repeats (a plain
    scatter of rows this wide keeps another row in most of them)."""
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((6, 16, 4, 16)).astype(np.float32)
    new = rng.standard_normal((4, 64, 4, 16)).astype(np.float32)
    bt = np.zeros((4, 6), np.int32)
    bt[0, :2] = [3, 5]  # slot 0: two pages; slots 1-3 idle (all sentinel)
    positions = np.zeros((4, 64), np.int32)
    positions[0] = 7 + np.arange(64)
    ref, ref_v = (np.asarray(JL.paged_kv_write(jnp.asarray(pool), jnp.asarray(n), jnp.asarray(bt),
                                               jnp.asarray(positions)))
                  for n in (new, new[::-1].copy()))
    for _ in range(20):
        k, v = L.paged_kv_write((torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy())),
                                (torch.from_numpy(new), torch.from_numpy(new[::-1].copy())),
                                torch.from_numpy(bt), torch.from_numpy(positions))
        np.testing.assert_array_equal(k.numpy(), ref)
        np.testing.assert_array_equal(v.numpy(), ref_v)
