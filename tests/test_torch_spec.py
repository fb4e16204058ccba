"""Port speculative decoding against ``repro.spec`` on the CPU in fp32: the
draft configuration, the acceptance rules (the random ones fed JAX's very
draws), the dense KV write rules at the sequence end, ``draft_propose``,
``spec_round`` / ``spec_decode_loop`` (a paged target with a dense draft),
``tree_verify_round`` with path compaction, and the proposers and router on
identical histories.  Weights come from the reference's init
(``params_from_numpy``); logits and K/V agree to atol 1e-4 / 1e-5 (fp32
through 2 layers, sums in another order); tokens and counts are equal, and
greedy speculation emits the plain greedy stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SpecDecodeConfig as JSpecDecodeConfig
from repro.configs.base import draft_config as jdraft_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.spec import draft as jdraft
from repro.spec import loop as jloop
from repro.spec import tree as jtree
from repro.spec import verify as jverify
from repro.spec.controller import AdaptiveGammaController as JController
from repro.spec.proposers import NgramProposer as JNgram
from repro.spec.proposers import ProposeContext as JContext
from repro.spec.proposers import ProposerRouter as JRouter
from repro.spec.proposers import StaticSuffixProposer as JSuffix
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.spec import draft as tdraft
from repro_torch.spec import loop as tloop
from repro_torch.spec import tree as ttree
from repro_torch.spec import verify as tverify
from repro_torch.spec.controller import AdaptiveGammaController
from repro_torch.spec.proposers import NgramProposer, ProposeContext, ProposerRouter
from repro_torch.spec.proposers import StaticSuffixProposer

JCFG = jconfigs.smoke_config("qwen3-1.7b")
CFG = configs.smoke_config("qwen3-1.7b")
JDCFG = jdraft_config(JCFG)
DCFG = configs.draft_config(CFG)
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
NP_DPARAMS = jax.tree.map(np.array, JT.init_params(JDCFG, jax.random.PRNGKey(1)))
PARAMS = params_from_numpy(NP_PARAMS, device="cpu")
DPARAMS = params_from_numpy(NP_DPARAMS, device="cpu")
JPARAMS = jax.tree.map(jnp.asarray, NP_PARAMS)
JDPARAMS = jax.tree.map(jnp.asarray, NP_DPARAMS)
B, PAGE, PER_SLOT, CHUNK = 3, 16, 4, 32
MAX_SEQ = PAGE * PER_SLOT
LOGITS_ATOL, KV_ATOL = 1e-4, 1e-5
F32 = dict(compute_dtype=jnp.float32)
TF32 = dict(compute_dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _clone(c):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in c.items()}


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def test_draft_config_of_qwen3_is_one_narrow_layer():
    d = configs.draft_config(configs.get_config("qwen3-1.7b"))
    assert (d.num_layers, d.d_model, d.num_heads, d.num_kv_heads,
            d.resolved_head_dim, d.d_ff, d.vocab_size) == (
        1, 1024, 8, 8, 128, 3072, 151936)
    ref = jdraft_config(jconfigs.get_config("qwen3-1.7b"))
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
              "d_ff", "vocab_size", "name"):
        assert getattr(d, f) == getattr(ref, f), f
    assert configs.SpecDecodeConfig() == configs.SpecDecodeConfig(
        **{f: getattr(JSpecDecodeConfig(), f)
           for f in configs.SpecDecodeConfig.__dataclass_fields__})


# ---------------------------------------------------------------------------
# acceptance rules
# ---------------------------------------------------------------------------


def _accept_inputs(seed, b=4, g=4, v=11):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, g + 1, v)).astype(np.float32)
    tgt = logits.argmax(-1)
    drafts = tgt[:, :g].copy()
    drafts[0, 1] = (drafts[0, 1] + 1) % v  # slot 0 rejects at 1
    drafts[2, 0] = (drafts[2, 0] + 3) % v  # slot 2 rejects at 0
    rem = np.asarray([9, 2, 9, 5][:b], np.int32)  # slot 1 cut by its budget
    probs = rng.dirichlet(np.ones(v), (b, g)).astype(np.float32)
    return drafts.astype(np.int32), logits, rem, probs


def _assert_rule_equal(got, ref):
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(_np(x), np.asarray(y))


@pytest.mark.parametrize("seed", [0, 1])
def test_accept_rules_match_reference_with_injected_draws(seed):
    drafts, logits, rem, probs = _accept_inputs(seed)
    td, tl, tr, tp = (torch.tensor(a) for a in (drafts, logits, rem, probs))
    jd, jl, jr, jp = (jnp.asarray(a) for a in (drafts, logits, rem, probs))
    _assert_rule_equal(tverify.greedy_accept(td, tl, tr),
                       jverify.greedy_accept(jd, jl, jr))
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, drafts.shape)
    _assert_rule_equal(
        tverify.simulated_accept_with(torch.tensor(np.asarray(u)), 0.6, td, tl, tr),
        jverify.simulated_accept(key, 0.6, jd, jl, jr))
    # sampled: the reference splits its key into the ratio test's uniforms
    # and the residual categorical, whose draw is argmax(log p + Gumbel)
    k_u, k_res = jax.random.split(key)
    u = jax.random.uniform(k_u, drafts.shape)
    noise = jax.random.gumbel(k_res, (drafts.shape[0], logits.shape[-1]), jnp.float32)
    got = tverify.sampled_accept_with(
        torch.tensor(np.asarray(u)), torch.tensor(np.asarray(noise)), td, tp, tl, tr)
    _assert_rule_equal(got, jverify.sampled_accept(key, jd, jp, jl, jr))


def test_controller_matches_reference():
    t, j = AdaptiveGammaController(), JController()
    for acc, prop in [(4, 4), (0, 2), (1, 4), (8, 8), (3, 3)]:
        for phase in ("conservative", "incremental", "stable"):
            assert t.gamma_for(phase) == j.gamma_for(phase)
        t.observe(acc, prop)
        j.observe(acc, prop)
        assert t.acceptance == j.acceptance
        assert t.round_cost_steps(2) == j.round_cost_steps(2)


# ---------------------------------------------------------------------------
# dense KV write rules at the sequence end (the draft's cache)
# ---------------------------------------------------------------------------


def _dense_layer_inputs(seed, c):
    rng = np.random.default_rng(seed)
    s, hd, kvh = 24, DCFG.resolved_head_dim, DCFG.num_kv_heads
    x = rng.standard_normal((B, c, DCFG.d_model)).astype(np.float32)
    k = rng.standard_normal((B, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((B, s, kvh, hd)).astype(np.float32)
    p = NP_DPARAMS["layers"]["attn"]
    p0 = {name: a[0] for name, a in p.items()}
    return x, k, v, p0


def test_dense_decode_write_clamps_at_the_end():
    x, k, v, p0 = _dense_layer_inputs(0, 1)
    idx = np.asarray([23, 24, 30], np.int32)  # last row, one past, far past
    jy, (jk, jv) = JL.attention_decode(
        JDCFG, jax.tree.map(jnp.asarray, p0), jnp.asarray(x),
        (jnp.asarray(k), jnp.asarray(v)), jnp.asarray(idx), impl="xla")
    tk, tv = torch.tensor(k), torch.tensor(v)
    ty, _ = L.attention_decode(
        DCFG, params_from_numpy(p0, device="cpu"), torch.tensor(x), (tk, tv),
        torch.tensor(idx))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=KV_ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=KV_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=KV_ATOL)
    assert not np.array_equal(tk.numpy()[1:, 23], k[1:, 23])  # clamped onto S - 1
    np.testing.assert_array_equal(tk.numpy()[:, :23], k[:, :23])  # nothing else


def test_dense_chunk_write_drops_past_the_end():
    x, k, v, p0 = _dense_layer_inputs(1, 8)
    idx = np.asarray([20, 0, 22], np.int32)
    lens = np.asarray([8, 3, 0], np.int32)  # slot 0 spills 4 rows past S
    jy, (jk, jv) = JL.attention_prefill_chunk(
        JDCFG, jax.tree.map(jnp.asarray, p0), jnp.asarray(x),
        (jnp.asarray(k), jnp.asarray(v)), jnp.asarray(idx), jnp.asarray(lens),
        impl="xla")
    tk, tv = torch.tensor(k), torch.tensor(v)
    ty, _ = L.attention_prefill_chunk(
        DCFG, params_from_numpy(p0, device="cpu"), torch.tensor(x), (tk, tv),
        torch.tensor(idx), torch.tensor(lens))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=KV_ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=KV_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=KV_ATOL)
    np.testing.assert_array_equal(tk.numpy()[2], k[2])  # frozen slot untouched
    np.testing.assert_array_equal(tk.numpy()[1, 3:], k[1, 3:])  # pad rows dropped


# ---------------------------------------------------------------------------
# draft proposal and the speculative loop: paged target + dense draft
# ---------------------------------------------------------------------------

PROMPT_LENS = (20, 9, 0)


#: draft pairings: the narrow 1-layer draft, and the target itself
#: (acceptance 1.0: every round takes the all-accept branch)
DRAFTS = {
    "narrow": (JDCFG, JDPARAMS, DCFG, DPARAMS),
    "self": (JCFG, JPARAMS, CFG, PARAMS),
}


def _states(draft="narrow"):
    """Both packages' target (paged) and draft (dense) caches after the
    prompts' chunk prefill, and the first generated tokens."""
    jdcfg, jdparams, dcfg, dparams = DRAFTS[draft]
    rng = np.random.default_rng(5)
    toks = np.zeros((B, CHUNK), np.int32)
    for i, n in enumerate(PROMPT_LENS):
        toks[i, :n] = rng.integers(0, CFG.vocab_size, n)
    lens = np.asarray(PROMPT_LENS, np.int32)
    num_pages = B * PER_SLOT + 1
    bt = np.zeros((B, PER_SLOT + 1), np.int32)
    bt[:, :PER_SLOT] = rng.permutation(np.arange(1, num_pages)).reshape(B, PER_SLOT)
    jc = JT.init_paged_cache(JCFG, B, num_pages, PAGE, PER_SLOT, jnp.float32)
    jc["block_tables"] = jnp.asarray(bt)
    jd = JT.init_cache(jdcfg, B, MAX_SEQ, jnp.float32)
    jd["index"] = jnp.zeros((B,), jnp.int32)
    jtok, jc = JT.prefill_chunks_into_slots(JCFG, JPARAMS, jnp.asarray(toks),
                                            jnp.asarray(lens), jc, **F32)
    _, jd = JT.prefill_chunks_into_slots(jdcfg, jdparams, jnp.asarray(toks),
                                         jnp.asarray(lens), jd, need_logits=False, **F32)
    tc = T.init_paged_cache(CFG, B, num_pages, PAGE, PER_SLOT, torch.float32, "cpu")
    tc["block_tables"] = torch.tensor(bt)
    td = T.init_cache(dcfg, B, MAX_SEQ, torch.float32, "cpu")
    ttok, tc = T.prefill_chunks_into_slots(CFG, PARAMS, torch.tensor(toks),
                                           torch.tensor(lens), tc, **TF32)
    _, td = T.prefill_chunks_into_slots(dcfg, dparams, torch.tensor(toks),
                                        torch.tensor(lens), td, need_logits=False, **TF32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    return (jtok, jc, jd), (ttok, tc, td)


def _assert_caches(jc, tc, paged):
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))
    for name in ("k", "v"):
        ref, got = np.asarray(jc["layers"][name]), tc["layers"][name].numpy()
        if paged:  # the sentinel page 0 takes colliding writes
            ref, got = ref[:, 1:], got[:, 1:]
        np.testing.assert_allclose(got, ref, rtol=0, atol=KV_ATOL)


def test_draft_propose_matches_reference():
    (jtok, _, jd), (ttok, _, td) = _states()
    jt, _, jd, _ = jdraft.draft_propose(JDCFG, JDPARAMS, jtok, jd, gamma=3, **F32)
    tt, probs, td, states = tdraft.draft_propose(DCFG, DPARAMS, ttok, td, gamma=3, **TF32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert probs is None and states is None
    _assert_caches(jd, td, paged=False)


@pytest.mark.parametrize("draft", DRAFTS)
def test_spec_loop_matches_reference_and_plain_greedy(draft):
    jdcfg, jdparams, dcfg, dparams = DRAFTS[draft]
    (jtok, jc, jd), (ttok, tc, td) = _states(draft)
    rem = np.asarray([12, 3, 0], np.int32)
    plain = T.decode_loop(CFG, PARAMS, ttok.clone(), _clone(tc),
                          torch.tensor(rem), k=12, max_seq=MAX_SEQ, **TF32)
    jout = jloop.spec_decode_loop(
        JCFG, jdcfg, JPARAMS, jdparams, jtok, jc, jd, jnp.asarray(rem),
        jax.random.PRNGKey(0), k=4, gamma=2, max_seq=MAX_SEQ, **F32)
    tout = tloop.spec_decode_loop(
        CFG, dcfg, PARAMS, dparams, ttok, tc, td, torch.tensor(rem), k=4,
        gamma=2, max_seq=MAX_SEQ, **TF32)
    jtok2, jc2, jd2, jrem = jout[:4]
    ttok2, tc2, td2, trem = tout[:4]
    np.testing.assert_array_equal(ttok2.numpy(), np.asarray(jtok2))
    np.testing.assert_array_equal(trem.numpy(), np.asarray(jrem))
    for got, ref in zip(tout[4:], jout[5:]):  # out, n_out, accepted, proposed, bad
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _assert_caches(jc2, tc2, paged=True)
    _assert_caches(jd2, td2, paged=False)
    # greedy speculation emits the plain greedy stream
    out, n_out = tout[4].numpy(), tout[5].numpy()
    toks_seq, steps = plain[3].numpy(), plain[4].numpy()
    for i in range(B):
        spec = [int(t) for j in range(out.shape[0]) for t in out[j, i, :n_out[j, i]]]
        assert spec == [int(t) for t in toks_seq[: steps[i], i]][: len(spec)]
        if draft == "self":  # every draft accepted: 4 rounds spend 12 tokens
            assert len(spec) == rem[i]
    if draft == "self":
        acc = tout[6].numpy()
        assert acc[:, 0].tolist() == [2] * 4 and acc[0, 1] == 2


def test_spec_round_random_modes_keep_the_accounting():
    (_, _, _), (ttok, tc, td) = _states()
    rem = torch.tensor([12, 3, 0], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    carry = (ttok, tc, td, rem)
    carry, (out, n_out, acc, prop, bad) = tloop.spec_round(
        CFG, DCFG, PARAMS, DPARAMS, carry, gamma=2, mode="simulated",
        max_seq=MAX_SEQ, sim_accept_p=1.0, gen=gen, **TF32)
    assert acc.tolist() == [2, 2, 0] and prop.tolist() == [2, 2, 0]
    assert n_out.tolist() == [3, 3, 0] and not bad.any()
    assert carry[1]["index"].tolist() == [23, 12, 0]
    assert carry[3].tolist() == [9, 0, 0]
    carry, (out, n_out, acc, prop, bad) = tloop.spec_round(
        CFG, DCFG, PARAMS, DPARAMS, carry, gamma=2, mode="sample",
        max_seq=MAX_SEQ, gen=gen, **TF32)
    assert 1 <= int(n_out[0]) <= 3 and n_out[1:].tolist() == [0, 0]
    assert carry[3].tolist() == [9 - int(n_out[0]), 0, 0]
    with pytest.raises(ValueError, match="Generator"):
        tloop.spec_round(CFG, DCFG, PARAMS, DPARAMS, carry, gamma=2,
                         mode="sample", max_seq=MAX_SEQ, **TF32)


# ---------------------------------------------------------------------------
# tree verification with KV path compaction
# ---------------------------------------------------------------------------


def test_tree_verify_round_matches_reference_and_plain_greedy():
    (jtok, jc, _), (ttok, tc, _) = _states()
    rem = np.asarray([6, 2, 0], np.int32)
    plain = T.decode_loop(CFG, PARAMS, ttok.clone(), _clone(tc),
                          torch.tensor(rem), k=6, max_seq=MAX_SEQ, **TF32)
    greedy = plain[3].numpy()  # [6, B]
    parents = ttree.branching_tree(2, 2)
    # branch 1 is wrong at its first node, branch 2 is the greedy chain
    # (slot 0), so the accepted path runs through nodes 3, 4
    tail = np.zeros((B, 4), np.int32)
    tail[:, 0] = (greedy[0] + 1) % CFG.vocab_size
    tail[:, 1] = greedy[1]
    tail[:, 2:] = greedy[:2].T
    jres = jtree.tree_verify_round(
        JCFG, JPARAMS, jtok, jc, jnp.asarray(tail), jnp.asarray(rem),
        jax.random.PRNGKey(0), parents=parents, max_seq=MAX_SEQ, **F32)
    tres = ttree.tree_verify_round(
        CFG, PARAMS, ttok, tc, torch.tensor(tail), torch.tensor(rem),
        parents=parents, max_seq=MAX_SEQ, **TF32)
    # tokens, cache, remaining | key | out, n_out, accepted, proposed, bad
    for got, ref in zip(tres[:1] + tres[2:], jres[:1] + jres[2:3] + jres[4:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _assert_caches(jres[1], tres[1], paged=True)
    # accepted: both nodes of branch 2 (slot 1's budget cuts it after one)
    assert tres[5].tolist() == [2, 2, 0] and tres[4].tolist() == [3, 2, 0]
    out, n_out = tres[3].numpy(), tres[4].numpy()
    for i in range(B):
        assert out[i, : n_out[i]].tolist() == greedy[: n_out[i], i].tolist()
    # the compacted path decodes on exactly as the plain stream does
    nxt, _ = T.decode_step(CFG, PARAMS, tres[0], tres[1], **TF32)
    assert int(nxt[0].argmax()) == int(greedy[3, 0])


@pytest.mark.parametrize("parents", [(-1, 0, 1), (-1, 0, 0, 2, 1, 4)])
def test_tree_greedy_accept_matches_reference(parents):
    rng = np.random.default_rng(len(parents))
    b, n, v = 4, len(parents), 5
    logits = rng.standard_normal((b, n, v)).astype(np.float32)
    toks = rng.integers(0, v, (b, n)).astype(np.int32)
    rem = np.asarray([9, 1, 3, 9], np.int32)
    got = ttree.tree_greedy_accept(parents, torch.tensor(toks), torch.tensor(logits),
                                   torch.tensor(rem))
    ref = jtree.tree_greedy_accept(parents, jnp.asarray(toks), jnp.asarray(logits),
                                   jnp.asarray(rem))
    _assert_rule_equal(got, ref)
    np.testing.assert_array_equal(ttree.tree_ancestor_masks(parents),
                                  jtree.tree_ancestor_masks(parents))


# ---------------------------------------------------------------------------
# proposers and router
# ---------------------------------------------------------------------------


def _histories():
    rng = np.random.default_rng(7)
    base = list(rng.integers(0, 9, 30))
    return [base, base[:12] + base[3:15], [], list(rng.integers(0, 3, 25))]


@pytest.mark.parametrize("width", [1, 2])
def test_proposers_match_reference_on_identical_histories(width):
    hists = _histories()
    active = np.asarray([True, True, False, True])
    corpus = [h for h in hists if h]
    pairs = [(NgramProposer(order=2), JNgram(order=2)),
             (StaticSuffixProposer(corpus), JSuffix(corpus))]
    for t, j in pairs:
        for gamma in (2, 4):
            tt = t.propose(ProposeContext(histories=hists, active=active, gamma=gamma,
                                          width=width))
            jt = j.propose(JContext(histories=hists, active=active, gamma=gamma,
                                    width=width))
            assert (tt is None) == (jt is None)
            if tt is not None:
                assert tt.parents == jt.parents
                np.testing.assert_array_equal(tt.tail, jt.tail)
                np.testing.assert_array_equal(tt.matched, jt.matched)


def test_router_matches_reference():
    t = ProposerRouter(["draft", "ngram"])
    j = JRouter(["draft", "ngram"])
    events = [(0, "ngram", 4, 4), (1, "ngram", 0, 4), (0, "draft", 1, 2),
              (2, "draft", 2, 2), (1, "draft", 2, 2)]
    for slot, name, acc, prop in events:
        t.observe(slot, name, acc, prop)
        j.observe(slot, name, acc, prop)
        for gamma in (1, 2, 4):
            assert t.pick(slot, gamma) == j.pick(slot, gamma)
            assert t.pick_majority([0, 1, 2], gamma) == j.pick_majority([0, 1, 2], gamma)
    t.reset_slot(0)
    j.reset_slot(0)
    assert t.acceptance(0, "ngram") == j.acceptance(0, "ngram")
    assert t.switches == j.switches
    assert t.round_cost("draft", 2) == j.round_cost("draft", 2)
