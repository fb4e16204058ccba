"""Port's Zamba2 hybrid family (zamba2-2.7b: Mamba2 layers with one shared
attention + MLP block) against the reference, on the CPU in fp32.

At ``smoke_config("zamba2-2.7b")`` (4 Mamba2 layers in 2 cycles, d_model 64,
4 MHA heads of 16, 8 SSM heads of 16, ssm_state 8), with the reference's
weights through ``bridge.params_from_numpy``: ``param_count`` against the
real tree; ``init_params``' names, shapes and dtypes; the SSD
(``ssd_chunked``) at lengths that are not whole 64-step chunks, from a
non-zero state; ``mamba2_step``; ``forward`` logits and ``lm_loss`` with
its gradients under each remat policy; ``prefill_into_slot`` (a bucket-
padded prompt into one slot); the padded-bucket prefill's exactness (the
port's own ``prefill`` at a 16-token bucket and unpadded: logits and four
decode steps bit-equal, as the reference's test); ``decode_step`` and
``decode_loop``; and the plain flash and dense decode attention at zamba2's
head dim 80 against the reference's XLA attention.  Inputs come from numpy
seeds.  Tolerances: atol 1e-5 on O(1) values (fp32, sums in another order),
1e-4 on logits and states after several layers, and gradients within 1e-4
of their largest value."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

ATOL = 1e-5
LOGITS_ATOL = 1e-4
GRAD_RTOL = 1e-4
JCFG = jconfigs.smoke_config("zamba2-2.7b")
CFG = configs.smoke_config("zamba2-2.7b")
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
PARAMS = params_from_numpy(NP_PARAMS, device="cpu")
MIXER0 = jax.tree.map(lambda a: a[0, 0].copy(), NP_PARAMS["layers"]["mixer"])


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


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# config and init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_cfg", [CFG, configs.get_config("zamba2-2.7b")],
                         ids=["smoke", "full"])
def test_param_count_matches_reference_and_the_real_tree(arch_cfg):
    """The analytic count (one shared block, Mamba2 layers) equals the
    reference's at both sizes, and the smoke tree's leaf sizes."""
    ref = (JCFG if arch_cfg is CFG else jconfigs.get_config("zamba2-2.7b"))
    assert arch_cfg.param_count() == ref.param_count()
    assert arch_cfg.active_param_count() == ref.active_param_count()
    assert arch_cfg.ssm_num_heads == ref.ssm_num_heads
    if arch_cfg is CFG:
        assert sum(t.numel() for t in tree_leaves(PARAMS)) == CFG.param_count()
        port = T.init_params(CFG, torch.Generator().manual_seed(0))
        assert sum(t.numel() for t in tree_leaves(port)) == CFG.param_count()


def test_smoke_config_matches_reference():
    assert configs.smoke_config("zamba2-2.7b") == CFG
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
                  "ssm_state", "ssm_head_dim", "shared_attn_every", "d_inner"):
        assert getattr(CFG, field) == getattr(JCFG, field), field


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_init_params_tree_matches_reference(dtype):
    """Every name, shape and dtype of the reference's tree: the Mamba2
    layers stacked [n_cyc, every, ...], ``params["shared"]`` beside them,
    ``A_log`` / ``D`` / ``dt_bias`` fp32 whatever the dtype."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = {tuple(p.key for p in path): (a.shape, str(a.dtype)) for path, a in
           jax.tree_util.tree_flatten_with_path(jax.eval_shape(
               lambda: JT.init_params(JCFG, jax.random.PRNGKey(0), jdtype)))[0]}
    port = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                port[path + (k,)] = (tuple(v.shape), str(v.dtype).split(".")[-1])

    walk(T.init_params(CFG, torch.Generator().manual_seed(0), dtype=dtype), ())
    assert port == {k: (tuple(s), d) for k, (s, d) in ref.items()}


# ---------------------------------------------------------------------------
# the SSD and the decode step
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, b, s, nh, hp, ds):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)) - 1)).astype(np.float32)
    B_ = rng.standard_normal((b, s, ds)).astype(np.float32)
    C_ = rng.standard_normal((b, s, ds)).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((b, nh, hp, ds)).astype(np.float32)
    return x, dt, B_, C_, A, h0


@pytest.mark.parametrize("s", [1, 63, 100, 130])
def test_ssd_chunked_matches_reference(s):
    """Lengths that leave a ragged last chunk (or are shorter than one),
    from a non-zero state: y and the final state."""
    args = _ssd_inputs(s, 2, s, 4, 8, 8)
    y_j, h_j = JSSM.ssd_chunked(*map(_j, args))
    y_t, h_t = SSM.ssd_chunked(*map(_t, args))
    assert tuple(y_t.shape) == (2, s, 4, 8) and tuple(h_t.shape) == (2, 4, 8, 8)
    _close(y_t, y_j, atol=1e-4)
    _close(h_t, h_j, atol=1e-4)


def test_ssd_chunked_equals_the_stepwise_recurrence():
    """The chunked form against ``mamba2_step``'s recurrence written out,
    one step at a time: ``h = exp(dt A) h + dt x B``, ``y = h C``."""
    x, dt, B_, C_, A, h0 = map(_t, _ssd_inputs(7, 1, 70, 2, 4, 8))
    y, h = SSM.ssd_chunked(x, dt, B_, C_, A, h0)
    hh, ys = h0.clone(), []
    for t in range(x.shape[1]):
        a = torch.exp(dt[:, t] * A)[..., None, None]
        hh = a * hh + (dt[:, t, :, None] * x[:, t])[..., None] * B_[:, t, None, None, :]
        ys.append(torch.einsum("bnxs,bs->bnx", hh, C_[:, t]))
    _close(y, torch.stack(ys, 1).numpy(), atol=1e-4)
    _close(h, hh.numpy(), atol=1e-4)


def test_mamba2_step_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, CFG.d_model)).astype(np.float32)
    st = {
        "conv_x": rng.standard_normal((3, CFG.ssm_conv - 1, CFG.d_inner)),
        "conv_bc": rng.standard_normal((3, CFG.ssm_conv - 1, 2 * CFG.ssm_state)),
        "h": rng.standard_normal((3, CFG.ssm_num_heads, CFG.ssm_head_dim, CFG.ssm_state)),
    }
    st = {k: v.astype(np.float32) for k, v in st.items()}
    y_j, st_j = JSSM.mamba2_step(JCFG, jax.tree.map(_j, MIXER0), _j(x), jax.tree.map(_j, st))
    y_t, st_t = SSM.mamba2_step(CFG, params_from_numpy(MIXER0, device="cpu"), _t(x),
                                {k: _t(v) for k, v in st.items()})
    _close(y_t, y_j)
    for k in st:
        _close(st_t[k], st_j[k])


def test_mamba2_block_matches_reference():
    x = np.random.default_rng(5).standard_normal((2, 70, CFG.d_model)).astype(np.float32)
    y_j = JSSM.mamba2_block(JCFG, jax.tree.map(_j, MIXER0), _j(x))
    y_t = SSM.mamba2_block(CFG, params_from_numpy(MIXER0, device="cpu"), _t(x))
    _close(y_t, y_j)


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_loss():
    """The reference's logits, loss and gradients on one batch (remat
    changes what the reference keeps, not its values: computed once)."""
    toks = _tokens(6, 2, 70)
    inputs, labels = toks[:, :-1], toks[:, 1:]
    jp = jax.tree.map(_j, NP_PARAMS)
    lj, _ = JT.forward(JCFG, jp, _j(inputs), compute_dtype=jnp.float32)
    (loss_j, _), gj = jax.value_and_grad(
        lambda p: JT.lm_loss(JCFG, p, _j(inputs), _j(labels), compute_dtype=jnp.float32),
        has_aux=True)(jp)
    return inputs, labels, lj, loss_j, gj


@pytest.mark.parametrize("policy", ["none", "dots", "full"])
def test_forward_loss_and_gradients_match_reference(policy, reference_loss):
    """Logits, loss and every parameter's gradient (the shared block's
    summed over its cycles) under each remat policy, fp32 compute."""
    inputs, labels, lj, loss_j, gj = reference_loss
    params = params_from_numpy(NP_PARAMS, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    lt, metrics = T.forward(CFG, params, _t(inputs), compute_dtype=torch.float32,
                            remat_policy=policy)
    _close(lt, lj, atol=LOGITS_ATOL)
    assert float(metrics["moe_aux"]) == 0.0
    loss_t, _ = T.lm_loss(CFG, params, _t(inputs), _t(labels), compute_dtype=torch.float32,
                          remat_policy=policy)
    grads = torch.autograd.grad(loss_t, leaves)
    assert abs(loss_t.item() - float(loss_j)) <= ATOL
    ref_grads = jax.tree.leaves(gj)
    assert len(grads) == len(ref_grads)
    for g, r in zip(grads, ref_grads):
        r = np.asarray(r)
        scale = max(np.abs(r).max(), 1e-12)
        assert np.abs(g.numpy() - r).max() / scale <= GRAD_RTOL


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


def test_bucketed_prefill_exact_for_ssm_state():
    """Port of ``tests/test_decode_attention.py::
    test_bucketed_prefill_exact_for_ssm_state[zamba2-2.7b]``: a 6-token
    prompt prefilled unpadded and zero-padded to a 16-token bucket gives
    bit-equal logits, and four decode steps from either cache stay
    bit-equal (the dt-masked pad leaves the SSM / conv state where the real
    tokens left it)."""
    toks = torch.tensor(_tokens(1, 1, 6))
    kw = dict(impl="torch", compute_dtype=torch.float32)
    logits_r, cache_r = T.prefill(CFG, PARAMS, toks, 32, **kw)
    padded = torch.zeros((1, 16), dtype=torch.int32)
    padded[:, :6] = toks
    logits_p, cache_p = T.prefill(CFG, PARAMS, padded, 32, length=6, **kw)
    assert torch.equal(logits_r, logits_p)
    for name, leaf in cache_r["layers"]["mamba"].items():
        assert torch.equal(leaf, cache_p["layers"]["mamba"][name]), name
    caches = [dict(c, index=c["index"].reshape(1)) for c in (cache_r, cache_p)]
    toks_r = toks_p = logits_r.argmax(-1).to(torch.int32)
    for _ in range(4):
        l_r, caches[0] = T.decode_step(CFG, PARAMS, toks_r, caches[0],
                                       compute_dtype=torch.float32, attn_impl="torch")
        l_p, caches[1] = T.decode_step(CFG, PARAMS, toks_p, caches[1],
                                       compute_dtype=torch.float32, attn_impl="torch")
        assert torch.equal(l_r, l_p)
        toks_r, toks_p = l_r.argmax(-1).to(torch.int32), l_p.argmax(-1).to(torch.int32)


def test_prefill_into_slot_with_bucket_padding_matches_reference():
    """A 13-token prompt padded to a 16 bucket into slot 1 of 3: the slot's
    Mamba2 state (batch on axis 2) and shared-block K/V rows (batch on axis
    1), its index and the first token equal the reference's; the other
    slots stay zero."""
    n, sb = 13, 16
    buf = np.zeros((1, sb), np.int32)
    buf[0, :n] = _tokens(2, 1, n)[0]
    jc = JT.init_cache(JCFG, 3, 32, jnp.float32)
    jc["index"] = jnp.zeros((3,), jnp.int32)
    tok_j, jc = JT.prefill_into_slot(JCFG, jax.tree.map(_j, NP_PARAMS), _j(buf), jnp.int32(n),
                                     jnp.int32(1), jc, max_seq=32, compute_dtype=jnp.float32)
    tc = T.init_cache(CFG, 3, 32, torch.float32, "cpu")
    ops.reset_launch_counts()
    tok_t, tc = T.prefill_into_slot(CFG, PARAMS, _t(buf), n, 1, tc, max_seq=32, impl="torch",
                                    compute_dtype=torch.float32)
    n_cyc = CFG.num_layers // CFG.shared_attn_every
    assert ops.launch_counts()["flash_attention_fwd"] == {"cuda": 0, "torch": n_cyc}
    assert int(tok_t) == int(tok_j)
    assert tc["index"].tolist() == [0, n, 0]
    for name, leaf in tc["layers"]["mamba"].items():
        _close(leaf, jc["layers"]["mamba"][name], atol=1e-4)
        assert not leaf[:, :, [0, 2]].any()
    for name in ("shared_k", "shared_v"):
        # rows past the prompt hold the pad tokens' K/V in both packages
        _close(tc["layers"][name], jc["layers"][name], atol=1e-4)
        assert not tc["layers"][name][:, [0, 2]].any()


def _random_cache(seed, b, s):
    rng = np.random.default_rng(seed)
    jc = JT.init_cache(JCFG, b, s, jnp.float32)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.5,
                        jc["layers"])


def test_decode_step_and_loop_match_reference():
    """A 3-slot cache with random states and K/V: one decode step (the
    shared block's K/V row written at each slot's index), then a fused loop
    where slot 2 has no budget (frozen token and index; its state still
    advances, as the reference's)."""
    layers = _random_cache(7, 3, 32)
    idx = np.asarray([4, 9, 2], np.int32)
    toks = _tokens(8, 1, 3)[0]
    jp = jax.tree.map(_j, NP_PARAMS)
    jc = {"index": _j(idx), "layers": jax.tree.map(_j, layers)}
    tc = {"index": _t(idx), "layers": jax.tree.map(lambda a: _t(a.copy()), layers)}
    lj, jc = JT.decode_step(JCFG, jp, _j(toks), jc, compute_dtype=jnp.float32)
    lt, tc = T.decode_step(CFG, PARAMS, _t(toks), tc, compute_dtype=torch.float32)
    _close(lt, lj, atol=LOGITS_ATOL)
    for name in ("shared_k", "shared_v"):
        _close(tc["layers"][name], jc["layers"][name], atol=1e-4)
    rem = np.asarray([5, 3, 0], np.int32)
    nxt = np.array(jnp.argmax(lj, -1).astype(jnp.int32))
    out_j = JT.decode_loop(JCFG, jp, _j(nxt), jc, _j(rem), k=4, max_seq=32,
                           compute_dtype=jnp.float32)
    out_t = T.decode_loop(CFG, PARAMS, _t(nxt), tc, _t(rem), k=4, max_seq=32,
                          compute_dtype=torch.float32)
    for a, b in zip((out_t[0], out_t[2], out_t[3], out_t[4]),
                    (out_j[0], out_j[2], out_j[3], out_j[4])):
        assert a.tolist() == np.asarray(b).tolist()
    assert out_t[1]["index"].tolist() == np.asarray(out_j[1]["index"]).tolist()
    for name, leaf in out_t[1]["layers"]["mamba"].items():
        _close(leaf, out_j[1]["layers"]["mamba"][name], atol=1e-4)
    _close(out_t[1]["layers"]["shared_k"], out_j[1]["layers"]["shared_k"], atol=1e-4)


def test_recurrent_states_select_and_graft_the_mamba_entry():
    layers = T.init_cache(CFG, 2, 8, torch.float32, "cpu")["layers"]
    st = T.chunk_recurrent_states(CFG, layers)
    assert st is layers["mamba"]
    # decode_chunk writes the mamba entry in place (the rollback grafts the
    # selected step back into these tensors) and captures it after each of
    # its T steps, the batch on axis 3 of the stack ([T, n_cyc, every, B, ...])
    cache = T.init_cache(CFG, 2, 8, torch.float32, "cpu")
    _, out, states = T.decode_chunk(CFG, PARAMS, torch.zeros((2, 3), dtype=torch.int32),
                                    cache, compute_dtype=torch.float32)
    assert T.recurrent_state_batch_axis(CFG) == 2
    assert states.keys() == cache["layers"]["mamba"].keys()
    for name, stack in states.items():
        live = out["layers"]["mamba"][name]
        assert live is cache["layers"]["mamba"][name]
        assert stack.shape == (3, *live.shape) and stack.shape[3] == 2
        assert torch.equal(stack[-1], live) and not torch.equal(stack[0], stack[-1])


# ---------------------------------------------------------------------------
# the attention cores at zamba2's head dim (80)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [64, 100])
def test_plain_flash_at_hd80_matches_reference_xla(s):
    """``ops.attention`` ([B, S, H, hd], MHA as zamba2's 32 / 32 heads, here
    4 / 4) at hd 80 against the reference's XLA attention, causal."""
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((2, s, 4, 80)).astype(np.float32) for _ in range(3))
    ref = jops.attention(_j(q), _j(k), _j(v), causal=True, impl="xla")
    out = ops.attention(_t(q), _t(k), _t(v), causal=True, impl="torch")
    _close(out, ref)
    assert 80 in tflash.HEAD_DIMS


def test_plain_dense_decode_at_hd80_matches_reference_xla():
    """The dense decode (#3) at hd 80, group 1, lengths on the 64-key tile
    edges and an empty slot, against the reference's XLA decode."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((6, 4, 80)).astype(np.float32)
    k, v = (rng.standard_normal((6, 160, 4, 80)).astype(np.float32) for _ in range(2))
    lengths = np.asarray([63, 64, 65, 0, 1, 160], np.int32)
    ref = jops.decode_attention(_j(q), _j(k), _j(v), _j(lengths), impl="xla")
    out = ops.decode_attention(_t(q), _t(k), _t(v), _t(lengths), impl="torch")
    _close(out, ref)
    tdec.check_head_dim(80, torch.bfloat16)
    tdec.check_head_dim(80, torch.float32)
