"""Port's audio (musicgen-large) and VLM (pixtral-12b) families against the
reference, on the CPU in fp32.

Both are the dense backbone over a stub frontend (``embed_inputs``): the
model takes precomputed d_model embeddings (EnCodec frames, ViT patches) in
place of tokens.  At each arch's smoke config (2 layers, d_model 64, 4
heads of 16; musicgen MHA with parametric LayerNorm, pixtral GQA with rope
theta 1e6), with the reference's weights through
``bridge.params_from_numpy``: ``param_count`` / ``active_param_count`` of
the full and smoke configs and ``draft_config``; LayerNorm at musicgen's
width and RoPE at theta 1e6 and hd 128; ``forward`` on embeddings and on
tokens; ``lm_loss`` and every gradient on embeddings against
``jax.value_and_grad`` of the reference's (outside ``make_train_step``,
which fails on this JAX, ROADMAP C1); ``prefill`` from embeddings equal
bit for bit to ``prefill`` from the same tokens, and against the
reference's; ``decode_step`` after it against ``forward`` at the next
position; one ``make_train_step`` step against the reference's
composition of ``repro.optim`` on the same stub-frontend batch;
``SyntheticDataset`` batches equal to the reference's; float inputs refused
by a config without ``embed_inputs``.  Inputs come from numpy seeds.
Tolerances: atol 1e-5 on O(1) values and on the loss and gradients (fp32,
sums in another order), 1e-4 on logits after 2 layers and the unembedding;
the train step's params within 2e-6 (test_torch_train's reasoning)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.base import draft_config as jdraft_config
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro.optim import make_schedule as jmake_schedule
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import TrainConfig, draft_config
from repro_torch.data import SyntheticDataset
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.runtime import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

ARCHS = ("musicgen-large", "pixtral-12b")
ATOL = 1e-5
LOGITS_ATOL = 1e-4
SEQ, BATCH = 24, 3


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


@functools.cache
def _setup(arch):
    """(reference cfg, port cfg, the reference's weights as numpy), once per
    arch and worker."""
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    return (jcfg, cfg, np_params)


def _embeddings(cfg, seed, b, s):
    """Random stand-ins for frontend embeddings, [b, s, d_model] fp32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, cfg.d_model)) * 0.5).astype(np.float32)


def _tokens(cfg, seed, b, s):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


# ---------------------------------------------------------------------------
# configs and layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_param_counts_and_draft_match_reference(arch):
    """The full and smoke configs (every field, ``embed_inputs`` and the
    family included), both parameter counts (the audio / VLM families count
    as dense), the smoke tree's size and ``draft_config``."""
    jcfg, cfg, np_params = _setup(arch)
    full, jfull = configs.get_config(arch), jconfigs.get_config(arch)
    for port, ref in ((full, jfull), (cfg, jcfg)):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
    assert full.embed_inputs and full.family == {"musicgen-large": "audio",
                                                 "pixtral-12b": "vlm"}[arch]
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(np_params)) == cfg.param_count()
    port_tree = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in tree_leaves(port_tree)) == cfg.param_count()
    for port, ref in ((full, jfull), (cfg, jcfg)):
        assert dataclasses.asdict(draft_config(port)) == dataclasses.asdict(jdraft_config(ref))


def test_layernorm_and_rope_at_the_slice_widths_match_reference():
    """musicgen's parametric LayerNorm at d_model 2048 and pixtral's RoPE at
    theta 1e6, hd 128, positions up to 4096 (the smoke configs run both only
    at width 64 / hd 16)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 2048)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(2048).astype(np.float32)
    mcfg, jmcfg = configs.get_config("musicgen-large"), jconfigs.get_config("musicgen-large")
    _close(L.norm(mcfg, _t(x), _t(w)), JL.norm(jmcfg, _j(x), _j(w)))
    q = rng.standard_normal((2, 9, 4, 128)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 511, 512, 1023, 2048, 4000, 4095]] * 2, np.int32)
    theta = configs.get_config("pixtral-12b").rope_theta
    assert theta == 1e6
    _close(L.apply_rope(_t(q), _t(pos), theta), JL.apply_rope(_j(q), _j(pos), theta))


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["embeddings", "tokens"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, kind):
    """Logits from precomputed embeddings (the frontend's path) and from
    token ids (the serving path's)."""
    jcfg, cfg, np_params = _setup(arch)
    inputs = (_embeddings(cfg, 2, BATCH, SEQ) if kind == "embeddings"
              else _tokens(cfg, 2, BATCH, SEQ))
    jlogits, _ = JT.forward(jcfg, jax.tree.map(_j, np_params), _j(inputs), impl="xla",
                            compute_dtype=jnp.float32)
    logits, metrics = T.forward(cfg, params_from_numpy(np_params, device="cpu"), _t(inputs),
                                compute_dtype=torch.float32)
    assert tuple(logits.shape) == (BATCH, SEQ, cfg.vocab_size)
    _close(logits, jlogits, atol=LOGITS_ATOL)
    assert float(metrics["moe_aux"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_on_embeddings_match_reference(arch):
    """``lm_loss`` and every parameter's gradient from embedding inputs
    against ``jax.value_and_grad`` of the reference's ``lm_loss``."""
    jcfg, cfg, np_params = _setup(arch)
    emb = _embeddings(cfg, 3, BATCH, SEQ)
    labels = _tokens(cfg, 4, BATCH, SEQ)

    def jloss(p):
        return JT.lm_loss(jcfg, p, _j(emb), _j(labels), impl="xla",
                          compute_dtype=jnp.float32)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(_j, np_params))
    params = params_from_numpy(np_params, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = T.lm_loss(cfg, params, _t(emb), _t(labels), compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert abs(loss.item() - float(jl)) <= ATOL
    assert abs(metrics["ce"].item() - float(jm["ce"])) <= ATOL
    ref = jax.tree.leaves(jg)
    assert len(grads) == len(ref)
    for p, g, r in zip(leaves, grads, ref):
        if p is params["embed"]:
            # the table is not read from embedding inputs: no gradient here,
            # zeros in the reference
            assert g is None and not np.asarray(r).any()
        else:
            _close(g, r)


def test_float_inputs_need_an_embed_inputs_config():
    """Float inputs to a config without ``embed_inputs`` raise (the
    reference asserts), in ``forward`` and in ``prefill``."""
    cfg = configs.smoke_config("qwen3-1.7b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    emb = _t(_embeddings(cfg, 5, 1, 8))
    with pytest.raises(ValueError, match="embedding inputs"):
        T.forward(cfg, params, emb, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="embedding inputs"):
        T.prefill(cfg, params, emb, 16, impl="torch", compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_from_embeddings_equals_prefill_from_tokens(arch):
    """A bucket-padded prompt fed as the embedding table's rows (what the
    engine's stub frontend does) gives logits and K/V bit-equal to the same
    tokens fed as ids; both equal the reference's ``prefill`` on those
    embeddings within the logits tolerance."""
    jcfg, cfg, np_params = _setup(arch)
    params = params_from_numpy(np_params, device="cpu")
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = _tokens(cfg, 6, 1, 11)
    emb = params["embed"][torch.from_numpy(toks).long()]
    kw = dict(impl="torch", compute_dtype=torch.float32, length=11)
    l_tok, c_tok = T.prefill(cfg, params, _t(toks), 32, **kw)
    l_emb, c_emb = T.prefill(cfg, params, emb, 32, **kw)
    assert torch.equal(l_tok, l_emb)
    assert int(c_emb["index"]) == 11
    for name in ("k", "v"):
        assert torch.equal(c_tok["layers"][name], c_emb["layers"][name])
    jl, jc = JT.prefill(jcfg, jax.tree.map(_j, np_params), _j(emb.numpy()), 32, impl="xla",
                        compute_dtype=jnp.float32, length=jnp.int32(11))
    _close(l_emb, jl, atol=LOGITS_ATOL)
    _close(c_emb["layers"]["k"], jc["layers"]["k"], atol=LOGITS_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_embedding_prefill_matches_forward(arch):
    """Prefill s positions from embeddings, then decode token ids: the
    logits at each step equal ``forward`` over the embeddings followed by
    those tokens' rows, at that position."""
    _, cfg, np_params = _setup(arch)
    params = params_from_numpy(np_params, device="cpu")
    s, steps = 10, 3
    emb = _t(_embeddings(cfg, 7, 2, s))
    toks = _t(_tokens(cfg, 8, 2, steps))
    _, cache = T.prefill(cfg, params, emb, 32, impl="torch", compute_dtype=torch.float32)
    cache = dict(cache, index=cache["index"].expand(2).contiguous())
    full = torch.cat([emb, params["embed"][toks.long()]], 1)
    ref, _ = T.forward(cfg, params, full, compute_dtype=torch.float32)
    for j in range(steps):
        logits, cache = T.decode_step(cfg, params, toks[:, j], cache,
                                      compute_dtype=torch.float32, attn_impl="torch")
        _close(logits, ref[:, s + j].numpy(), atol=LOGITS_ATOL)
    assert cache["index"].tolist() == [s + steps] * 2


# ---------------------------------------------------------------------------
# data and the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_dataset_embedding_batches_equal_reference(arch):
    """Three batches of the stub frontend's fp32 embeddings and int32
    labels, bit-equal to the reference's (the port draws its table once,
    the reference once per batch, from the same seed)."""
    jcfg, cfg, _ = _setup(arch)
    jds = JDataset(jcfg, seq_len=16, global_batch=4, seed=3)
    tds = SyntheticDataset(cfg, seq_len=16, global_batch=4, seed=3)
    for _ in range(3):
        jb, tb = jds.next_batch(), tds.next_batch()
        assert tb.keys() == jb.keys()
        assert tb["inputs"].shape == (4, 16, cfg.d_model)
        for key in jb:
            assert tb[key].dtype == jb[key].dtype
            np.testing.assert_array_equal(tb[key], jb[key])


TRAIN_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10, compute_dtype="float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_embedding_batches_matches_reference(arch):
    """Two ``make_train_step`` steps on the stub frontend's batches against
    the reference's loss, clip, schedule and AdamW jitted together (its own
    ``make_train_step`` fails on this JAX, C1): loss, ce and grad norm
    within 1e-5 relative, lr to fp32 rounding, params within 2e-6."""
    jcfg, cfg, np_params = _setup(arch)
    jtcfg = JTrainConfig(**TRAIN_KW)
    sched = jmake_schedule(jtcfg)

    @jax.jit
    def jstep(state, batch):
        def loss_fn(p):
            return JT.lm_loss(jcfg, p, batch["inputs"], batch["labels"], impl="xla",
                              compute_dtype=jnp.float32)

        (loss, m), g = jax.value_and_grad(loss_fn, has_aux=True)(state["params"])
        g, gnorm = jclip(jax.tree.map(lambda x: x.astype(jnp.float32), g),
                         jtcfg.grad_clip_norm)
        lr = sched(state["opt"]["step"])
        new_p, new_opt = jadamw_update(g, state["opt"], state["params"], lr=lr, cfg=jtcfg)
        return {"params": new_p, "opt": new_opt}, {"loss": loss, "ce": m["ce"],
                                                   "grad_norm": gnorm, "lr": lr}

    jparams = jax.tree.map(_j, np_params)
    jstate = {"params": jparams, "opt": jadamw_init(jparams)}
    step = make_train_step(cfg, TrainConfig(**TRAIN_KW), device="cpu")
    state = init_train_state(params_from_numpy(np_params, device="cpu"))
    jds = JDataset(jcfg, seq_len=SEQ, global_batch=4, seed=7)
    tds = SyntheticDataset(cfg, seq_len=SEQ, global_batch=4, seed=7)
    for _ in range(2):
        jb, tb = jds.next_batch(), tds.next_batch()
        assert tb["inputs"].dtype == np.float32 and tb["inputs"].ndim == 3
        jstate, jm = jstep(jstate, {k: _j(v) for k, v in jb.items()})
        state, m = step(state, tb)
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5)
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]), rtol=1e-7)
    tflat = _flat(state["params"])
    for name, ref in _flat(jstate["params"]).items():
        np.testing.assert_allclose(tflat[name], ref, rtol=0, atol=2e-6, err_msg=name)
