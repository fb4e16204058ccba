"""Port's dense target layout and monolithic prefill against the reference,
on the CPU in fp32.

Kernels: the plain dense chunk-verify (#6) and tree-verify (#8) against the
reference's Pallas kernels (interpret mode, as its own tests run them) and
its XLA paths -- empty slots, empty causal windows, full rows, a chain equal
to verify.  Model pieces: ``attention_verify`` (with the reference's start
clamp at the sequence end), ``_compact_dense``, ``decode_chunk`` on dense
rows (chain and tree), monolithic ``prefill`` / ``prefill_into_slot`` (a
bucket-padded prompt), ``prefill_into_slot_paged`` and
``prefill_suffix_into_slot``.  Engines: ``EngineCore`` runs on the dense
layout with chunked and monolithic prefill, plain, draft-paired and n-gram,
and on the paged layout with monolithic prefill and a radix hit (the suffix
prefill), must give the reference's token streams, finish reasons, every
step's ``StepOutputs`` and counters, and speculating streams equal the plain
greedy ones.  Inputs come from numpy seeds, weights from the reference's
init through ``bridge.params_from_numpy``; tolerance atol 1e-5 (fp32, sums
in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SpecDecodeConfig as JSpecDecodeConfig
from repro.configs.base import draft_config as jdraft_config
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import core as jserving
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.spec import tree as jtree
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SpecDecodeConfig
from repro_torch.kernels import ops
from repro_torch.kernels import tree_verify_attention as ttva
from repro_torch.kernels import verify_attention as tva
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import core as tserving
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.spec import tree as ttree

ATOL = 1e-5
IMPLS = ("pallas", "xla")
JCFG = jconfigs.smoke_config("qwen3-1.7b")
CFG = configs.smoke_config("qwen3-1.7b")
JDCFG, DCFG = jdraft_config(JCFG), configs.draft_config(CFG)
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
NP_DPARAMS = jax.tree.map(np.array, JT.init_params(JDCFG, jax.random.PRNGKey(1)))
PARAMS = params_from_numpy(NP_PARAMS, device="cpu")
LAYER0 = jax.tree.map(lambda a: a[0].copy(), NP_PARAMS["layers"])


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


def _kv(seed, b, s, kvh, hd):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    return rng, k, v


# ---------------------------------------------------------------------------
# dense verify (#6) and tree verify (#8)
# ---------------------------------------------------------------------------

VERIFY_CASES = [
    # (seed, b, t, h, kvh, hd, s, lengths): empty slot, lengths < T, a full row
    (0, 4, 3, 4, 4, 16, 40, [0, 2, 40, 17]),
    (1, 3, 5, 8, 2, 32, 64, [64, 5, 30]),
    (2, 2, 2, 4, 2, 16, 24, [1, 24]),
]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", VERIFY_CASES, ids=lambda c: f"seed{c[0]}")
def test_dense_verify_plain_matches_reference(case, impl):
    seed, b, t, h, kvh, hd, s, lengths = case
    rng, k, v = _kv(seed, b, s, kvh, hd)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    ref = jops.verify_attention(_j(q), _j(k), _j(v), _j(lens), impl=impl)
    out = ops.verify_attention(_t(q), _t(k), _t(v), _t(lens), impl="torch")
    _close(out, ref)
    rows = (lens[:, None] - t + np.arange(t)[None, :]) < 0  # empty windows
    assert not out[torch.from_numpy(rows)].any()


TREES = {
    "chain": jtree.linear_chain(4),
    "branching(2, 2)": jtree.branching_tree(2, 2),
    "31 nodes": jtree.branching_tree(3, 10),
}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("tree", list(TREES))
def test_dense_tree_verify_plain_matches_reference(tree, impl):
    parents = TREES[tree]
    n = len(parents)
    rng, k, v = _kv(3, 3, 48, 2, 16)
    q = rng.standard_normal((3, n, 4, 16)).astype(np.float32)
    lens = np.asarray([0, n + 9, 48], np.int32)
    anc = np.broadcast_to(np.asarray(jtree.tree_ancestor_masks(parents)), (3, n)).astype(np.int32)
    ref = jops.tree_verify_attention(_j(q), _j(k), _j(v), _j(lens), _j(anc), impl=impl)
    out = ops.tree_verify_attention(_t(q), _t(k), _t(v), _t(lens), _t(anc), impl="torch")
    _close(out, ref)
    assert not out[0].any()  # lengths == 0: every row sees nothing
    if tree == "chain":
        chain = ops.verify_attention(_t(q), _t(k), _t(v), _t(lens), impl="torch")
        torch.testing.assert_close(out, chain, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the tensor-core route of #6 / #8: its body route, its cluster plan, and a
# numpy emulation of its split walk and rank-ordered merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,hd,body", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"), (torch.bfloat16, 80, "fma"),
    (torch.bfloat16, 96, "fma"), (torch.float32, 128, "fma"), (torch.float32, 64, "fma"),
])
def test_dense_verify_body_route(dtype, hd, body):
    """Both dense verify kernels launch through ``launch_dense_verify``,
    which picks the body by the paged verify's rule: the tensor cores for
    bf16 at hd 64 / 128, the FMA body else."""
    assert tva.verify_body(dtype, hd) == body
    assert ttva.launch_dense_verify is tva.launch_dense_verify


@pytest.mark.parametrize("hd", [64, 128])
def test_dense_verify_plan_covers_every_tile_once(hd):
    """For S = 1..1024 the cluster's CTAs cover every 64-key tile of the slot
    exactly once, in rank order, none holds more than ``tiles_per_cta``
    tiles, the cluster stays within the portable 8 CTAs, and a CTA fits the
    card's shared memory."""
    for s in range(1, 1025):
        n_tiles = -(-s // 64)
        per, size = tva.dense_verify_plan(s)
        covered = [j for r in range(size) for j in range(r * per, min((r + 1) * per, n_tiles))]
        assert covered == list(range(n_tiles)), (s, per, size)
        assert per >= 2 and 1 <= size <= tva.MAX_CLUSTER and (size - 1) * per < n_tiles
        assert tva.tc_smem_bytes(hd) <= tva.MAX_SMEM
    # the serving S = 512: 8 tiles, two a CTA, clusters of 4
    assert tva.dense_verify_plan(512) == (2, 4)


LOG2E = 1.4426950408889634


def _tc_emulation(q, k, v, lengths, anc=None):
    """numpy emulation, in fp32 and in the kernel's units, of the tensor-core
    route of ``csrc/verify_attention.cu``: per (slot, kv head, 64-row q
    tile), the cluster's CTA of rank r walks 64-key tiles r * per ..
    r * per + per - 1 up to the q tile's visibility end (keys past it
    zero-filled and hidden), keeping m in raw scores and p = exp2((s - m)
    scale log2 e); the merge weighs each rank that saw a key by exp2((m_r -
    M) scale log2 e) and sums (O, l) in rank order.  Rows that see no key
    give zeros."""
    nb, c, h, hd = q.shape
    _, s, kvh, _ = k.shape
    group, rows = h // kvh, c * (h // kvh)
    per, size = tva.dense_verify_plan(s)
    sl2 = np.float32(hd**-0.5 * LOG2E)
    out = np.zeros_like(q)
    kpos = np.arange(s)
    for b in range(nb):
        start = int(lengths[b]) - c
        for head in range(kvh):
            for r0 in range(0, rows, 64):
                R = np.arange(r0, min(r0 + 64, rows))
                t, qh = R // group, head * group + R % group
                if anc is None:
                    kmax = min(start + min(int(t[-1]) + 1, c), s)
                    seen = kpos[None, :] <= start + t[:, None]
                else:
                    kmax = min(start + c, s)
                    j = kpos[None, :] - start
                    bits = (anc[b, t][:, None] >> np.clip(j, 0, 31)) & 1
                    seen = (j < 0) | ((j < c) & (bits == 1))
                nk = -(-kmax // 64) if kmax > 0 else 0
                ms, ls, os_ = [], [], []
                for rank in range(size):
                    m = np.full(len(R), -np.inf, np.float32)
                    l = np.zeros(len(R), np.float32)
                    o = np.zeros((len(R), hd), np.float32)
                    for jt in range(rank * per, min((rank + 1) * per, nk)):
                        kp = np.arange(jt * 64, jt * 64 + 64)
                        inb = kp < kmax
                        kc = np.minimum(kp, s - 1)
                        kk = np.where(inb[:, None], k[b, kc, head], 0).astype(np.float32)
                        vv = np.where(inb[:, None], v[b, kc, head], 0).astype(np.float32)
                        sc = np.where(inb[None, :] & seen[:, kc], q[b, t, qh] @ kk.T, -np.inf)
                        mx = np.maximum(m, sc.max(axis=1))
                        bb = np.where(mx == -np.inf, 0, mx * sl2).astype(np.float32)
                        p = np.exp2(sc * sl2 - bb[:, None]).astype(np.float32)
                        corr = np.exp2(m * sl2 - bb).astype(np.float32)
                        l = l * corr + p.sum(axis=1)
                        o = o * corr[:, None] + p @ vv
                        m = mx
                    ms.append(m)
                    ls.append(l)
                    os_.append(o)
                saw = [li > 0 for li in ls]
                M = np.max([np.where(sw, mi, -np.inf) for sw, mi in zip(saw, ms)], axis=0)
                L = np.zeros(len(R), np.float32)
                O = np.zeros((len(R), hd), np.float32)
                for sw, mi, li, oi in zip(saw, ms, ls, os_):  # rank order
                    w = np.where(sw, np.exp2((np.where(sw, mi, 0) - np.where(sw, M, 0)) * sl2), 0)
                    L = L + w * li
                    O = O + w[:, None] * oi
                out[b, t, qh] = np.where(L[:, None] > 0, O / np.where(L > 0, L, 1)[:, None], 0)
    return out


EMU_VERIFY_CASES = VERIFY_CASES + [
    # (seed, b, t, h, kvh, hd, s, lengths): clusters of 3, 8 and 6 CTAs (two
    # and three tiles a CTA), lengths < T, 0 and past S, two q tiles (T=40)
    (3, 3, 5, 4, 2, 16, 300, [0, 3, 290]),
    (4, 2, 5, 4, 2, 16, 1000, [1000, 1007]),
    (5, 2, 40, 4, 2, 16, 1100, [700, 35]),
]


@pytest.mark.parametrize("case", EMU_VERIFY_CASES, ids=lambda c: f"seed{c[0]}")
def test_dense_verify_cluster_emulation_matches_plain(case):
    seed, b, t, h, kvh, hd, s, lengths = case
    rng, k, v = _kv(seed, b, s, kvh, hd)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    emu = _tc_emulation(q, k, v, lens)
    plain = ops.verify_attention(_t(q), _t(k), _t(v), _t(lens), impl="torch")
    assert np.isfinite(emu).all()
    _close(plain, emu)
    rows = (lens[:, None] - t + np.arange(t)[None, :]) < 0  # empty windows: zeros
    assert not emu[rows].any()


@pytest.mark.parametrize("tree", list(TREES))
def test_dense_tree_cluster_emulation_matches_plain(tree):
    """Over S = 300 (clusters of 3) at group 4, where the 31-node tree's 124
    rows take two q tiles; a chain's emulation equals verify's bit for bit."""
    parents = TREES[tree]
    n = len(parents)
    rng, k, v = _kv(6, 5, 300, 2, 16)
    q = rng.standard_normal((5, n, 8, 16)).astype(np.float32)
    lens = np.asarray([0, n - 2, n + 9, 300, 305], np.int32)
    anc = np.broadcast_to(np.asarray(jtree.tree_ancestor_masks(parents)), (5, n)).astype(np.int32)
    emu = _tc_emulation(q, k, v, lens, anc)
    plain = ops.tree_verify_attention(_t(q), _t(k), _t(v), _t(lens), _t(anc), impl="torch")
    assert np.isfinite(emu).all()
    _close(plain, emu)
    assert not emu[0].any()  # lengths == 0: every row sees nothing
    if tree == "chain":
        assert np.array_equal(emu, _tc_emulation(q, k, v, lens))


def test_dense_verify_plain_versions_leave_body_counts_at_zero():
    ops.reset_launch_counts()
    qc = torch.zeros((2, 3, 4, 16))
    kv = torch.zeros((2, 8, 2, 16))
    lens = torch.tensor([3, 8], dtype=torch.int32)
    anc = torch.tensor([[1, 3, 7]] * 2, dtype=torch.int32)
    for impl in ("auto", "torch"):
        ops.verify_attention(qc, kv, kv, lens, impl=impl)
        ops.tree_verify_attention(qc, kv, kv, lens, anc, impl=impl)
    for name in ("verify_attention", "tree_verify_attention"):
        assert ops.launch_counts()[name] == {"cuda": 0, "torch": 2}
        assert ops.body_counts()[name] == {"tc": 0, "fma": 0}
    ops.reset_launch_counts()


# ---------------------------------------------------------------------------
# attention_verify, compaction and decode_chunk on dense rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree", [None, "branching(2, 2)"])
def test_attention_verify_matches_reference_at_the_sequence_end(tree):
    """Slot 1's chunk would run past S: JAX clamps the write's START into
    [0, S - T], so the chunk lands shifted onto the last T rows."""
    b, t, s = 3, (5 if tree is None else len(TREES[tree])), 24
    rng, k, v = _kv(4, b, s, CFG.num_kv_heads, CFG.resolved_head_dim)
    x = rng.standard_normal((b, t, CFG.d_model)).astype(np.float32)
    idx = np.asarray([3, s - 2, s - t], np.int32)
    kw_j, kw_t = {}, {}
    if tree is not None:
        par = TREES[tree]
        anc = np.broadcast_to(np.asarray(jtree.tree_ancestor_masks(par)), (b, t)).astype(np.int32)
        dep = np.asarray(jtree.tree_depths(par), np.int32)
        kw_j, kw_t = dict(anc=_j(anc), depths=_j(dep)), dict(anc=_t(anc), depths=_t(dep))
    y_j, (k_j, v_j) = JL.attention_verify(JCFG, jax.tree.map(_j, LAYER0["attn"]), _j(x),
                                          (_j(k), _j(v)), _j(idx), impl="xla", **kw_j)
    kt, vt = _t(k.copy()), _t(v.copy())
    y_t, _ = L.attention_verify(CFG, params_from_numpy(LAYER0["attn"], device="cpu"), _t(x),
                                (kt, vt), _t(idx), impl="torch", **kw_t)
    _close(y_t, y_j)
    _close(kt, k_j)
    _close(vt, v_j)


def test_compact_dense_matches_reference_at_the_sequence_end():
    """Source rows past S clamp to S - 1; the destination start clamps into
    [0, S - N]."""
    rng = np.random.default_rng(5)
    l, b, s, n = 2, 3, 20, 5
    kc = rng.standard_normal((l, b, s, 2, 8)).astype(np.float32)
    idx0 = np.asarray([2, 17, s - n], np.int32)
    comp = np.asarray([[0, 2, 4, 3, 4], [0, 1, 2, 3, 4], [0, 3, 4, 3, 4]], np.int32)
    ref = jax.vmap(lambda c: jtree._compact_dense(c, _j(idx0), _j(comp)))(_j(kc))
    port = _t(kc.copy())
    ttree._compact_dense(port, _t(idx0), _t(comp))
    _close(port, ref, atol=0)


@pytest.mark.parametrize("tree", [None, "branching(2, 2)"])
def test_decode_chunk_on_dense_rows_matches_reference(tree):
    b, s = 2, 40
    rng = np.random.default_rng(6)
    jcache = JT.init_cache(JCFG, b, s, jnp.float32)
    shape = jcache["layers"]["k"].shape
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    idx = np.asarray([7, s - 3], np.int32)
    n = 4 if tree is None else len(TREES[tree])
    toks = rng.integers(0, CFG.vocab_size, (b, n)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if tree is not None:
        par = TREES[tree]
        anc = np.broadcast_to(np.asarray(jtree.tree_ancestor_masks(par)), (b, n)).astype(np.int32)
        dep = np.asarray(jtree.tree_depths(par), np.int32)
        kw_j, kw_t = dict(anc=_j(anc), depths=_j(dep)), dict(anc=_t(anc), depths=_t(dep))
    jc = {"index": _j(idx), "layers": {"k": _j(k), "v": _j(v)}}
    lj, jc, _ = JT.decode_chunk(JCFG, jax.tree.map(_j, NP_PARAMS), _j(toks), jc,
                                compute_dtype=jnp.float32, attn_impl="xla", **kw_j)
    tc = {"index": _t(idx), "layers": {"k": _t(k.copy()), "v": _t(v.copy())}}
    lt, tc, _ = T.decode_chunk(CFG, PARAMS, _t(toks), tc, compute_dtype=torch.float32,
                               attn_impl="torch", **kw_t)
    _close(lt, lj, atol=1e-4)
    _close(tc["layers"]["k"], jc["layers"]["k"])
    assert tc["index"].tolist() == np.asarray(jc["index"]).tolist()


# ---------------------------------------------------------------------------
# monolithic prefill
# ---------------------------------------------------------------------------


def test_prefill_into_slot_with_bucket_padding_matches_reference():
    """A 13-token prompt padded to a 16 bucket, into slot 1 of a 3-slot
    dense cache: the slot's row, its index and the first token equal the
    reference's; the logits equal the unpadded prompt's."""
    rng = np.random.default_rng(7)
    n, sb, max_seq = 13, 16, 32
    prompt = rng.integers(0, CFG.vocab_size, n).astype(np.int32)
    buf = np.zeros((1, sb), np.int32)
    buf[0, :n] = prompt
    jc = JT.init_cache(JCFG, 3, max_seq, jnp.float32)
    jc["index"] = jnp.zeros((3,), jnp.int32)
    tok_j, jc = JT.prefill_into_slot(JCFG, jax.tree.map(_j, NP_PARAMS), _j(buf), jnp.int32(n),
                                     jnp.int32(1), jc, max_seq=max_seq, impl="xla",
                                     compute_dtype=jnp.float32)
    tc = T.init_cache(CFG, 3, max_seq, torch.float32, "cpu")
    tok_t, tc = T.prefill_into_slot(CFG, PARAMS, _t(buf), n, 1, tc, max_seq=max_seq,
                                    impl="torch", compute_dtype=torch.float32)
    assert int(tok_t) == int(tok_j)
    _close(tc["layers"]["k"], jc["layers"]["k"])
    _close(tc["layers"]["v"], jc["layers"]["v"])
    assert tc["index"].tolist() == [0, n, 0]
    lp, _ = T.prefill(CFG, PARAMS, _t(buf), max_seq, impl="torch",
                      compute_dtype=torch.float32, length=n)
    lu, _ = T.prefill(CFG, PARAMS, _t(prompt[None]), max_seq, impl="torch",
                      compute_dtype=torch.float32)
    _close(lp, lu.numpy())


def _paged_case():
    page, per_slot, b = 16, 4, 2
    bt = np.zeros((b, per_slot + 1), np.int32)
    bt[0, :3] = [3, 1, 6]
    bt[1, :3] = [3, 1, 8]  # slot 1 shares slot 0's first two pages
    jc = JT.init_paged_cache(JCFG, b, b * per_slot + 1, page, per_slot, jnp.float32)
    jc["block_tables"] = _j(bt)
    tc = T.init_paged_cache(CFG, b, b * per_slot + 1, page, per_slot, torch.float32, "cpu")
    tc["block_tables"] = _t(bt)
    return jc, tc


def test_paged_monolithic_and_suffix_prefill_match_reference():
    """Slot 0 prefills 40 tokens (bucket 48) into its pages; slot 1 shares
    the first 32 of them and prefills its 9-token suffix (bucket 16)
    through the paged verify pass."""
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, CFG.vocab_size, 40).astype(np.int32)
    buf = np.zeros((1, 48), np.int32)
    buf[0, :40] = prompt
    suffix = rng.integers(0, CFG.vocab_size, 9).astype(np.int32)
    sbuf = np.zeros((1, 16), np.int32)
    sbuf[0, :9] = suffix
    jc, tc = _paged_case()
    jp = jax.tree.map(_j, NP_PARAMS)
    tok_j, jc = JT.prefill_into_slot_paged(JCFG, jp, _j(buf), jnp.int32(40), jnp.int32(0), jc,
                                           impl="xla", compute_dtype=jnp.float32)
    tok_t, tc = T.prefill_into_slot_paged(CFG, PARAMS, _t(buf), 40, 0, tc, impl="torch",
                                          compute_dtype=torch.float32)
    assert int(tok_t) == int(tok_j)
    suf_j, jc = JT.prefill_suffix_into_slot(JCFG, jp, _j(sbuf), jnp.int32(9), jnp.int32(32),
                                            jnp.int32(1), jc, compute_dtype=jnp.float32,
                                            attn_impl="xla")
    suf_t, tc = T.prefill_suffix_into_slot(CFG, PARAMS, _t(sbuf), 9, 32, 1, tc,
                                           compute_dtype=torch.float32, attn_impl="torch")
    assert int(suf_t) == int(suf_j)
    assert tc["index"].tolist() == np.asarray(jc["index"]).tolist() == [40, 41]
    live = [1, 3, 6, 8]  # the pages both slots map (the sentinel takes pad rows)
    _close(tc["layers"]["k"][:, live], np.asarray(jc["layers"]["k"])[:, live])
    _close(tc["layers"]["v"][:, live], np.asarray(jc["layers"]["v"])[:, live])


# ---------------------------------------------------------------------------
# EngineCore: dense layout x {chunked, monolithic} x {plain, draft, ngram};
# paged monolithic with a radix hit
# ---------------------------------------------------------------------------

MAX_SLOTS, MAX_SEQ = 2, 96
COUNTERS = ("engine/spec_rounds", "engine/spec_drafted", "engine/spec_accepted",
            "engine/prefill_prompt_tokens", "engine/prefill_skipped_tokens",
            "engine/prefill_metered_tokens", "engine/generated_tokens",
            "engine/d2h_transfers", "engine/steps_executed", "core/preemptions")


class Clock:
    """Virtual clock advanced by the test between steps only."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engine(pkg, proposer, clock, **kw):
    if pkg == "jax":
        spec = {} if proposer is None else {"spec": JSpecDecodeConfig(proposer=proposer)}
        if proposer == "draft":
            spec.update(draft_cfg=JDCFG, draft_params=jax.tree.map(jnp.asarray, NP_DPARAMS))
        return JEngine(JCFG, jax.tree.map(jnp.asarray, NP_PARAMS), compute_dtype=jnp.float32,
                       clock=clock, prefill_impl="xla", max_slots=MAX_SLOTS,
                       max_seq=MAX_SEQ, **spec, **kw)
    spec = {} if proposer is None else {"spec": SpecDecodeConfig(proposer=proposer)}
    if proposer == "draft":
        spec.update(draft_cfg=DCFG, draft_params=params_from_numpy(NP_DPARAMS, device="cpu"))
    return TEngine(CFG, params_from_numpy(NP_PARAMS, device="cpu"),
                   compute_dtype=torch.float32, clock=clock, device="cpu",
                   decode_impl="torch", max_slots=MAX_SLOTS,
                   max_seq=MAX_SEQ, **spec, **kw)


def _prompts():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, CFG.vocab_size, 32)  # two full 16-token pages
    a = np.concatenate([shared, rng.integers(0, CFG.vocab_size, 14)])  # 46
    b = rng.integers(0, CFG.vocab_size, 40)
    c = np.concatenate([shared, rng.integers(0, CFG.vocab_size, 5)])  # 37
    d = rng.integers(0, CFG.vocab_size, 20)
    return a, b, c, d


def _normalize(out, order):
    ids = lambda xs: [order[i] for i in xs]
    return {
        "admitted": ids(out.admitted), "preempted": ids(out.preempted),
        "finished": ids([cr.request_id for cr in out.finished]),
        "k": out.k, "gamma": out.gamma, "proposer": out.proposer,
        "spec_accepted": out.spec_accepted, "spec_proposed": out.spec_proposed,
        "prefill_tokens": out.prefill_tokens, "cost_steps": out.cost_steps,
        "outputs": sorted(
            (order[o.request_id], tuple(o.new_tokens), o.state.value, o.finish_reason,
             o.ttft_s)
            for o in out.outputs
        ),
    }


def _serve(pkg, proposer, **kw):
    """Two OFFLINE requests under a token budget, an ONLINE arrival that
    shares a 32-token prefix and preempts one of them, and a late OFFLINE
    one.  Returns the per-step outputs, the streams and the counters."""
    clock = Clock()
    eng = _engine(pkg, proposer, clock, **kw)
    mod = jserving if pkg == "jax" else tserving
    core = eng.core
    a, b, c, d = _prompts()
    order = {}

    def submit(prompt, n, priority):
        cr = core.submit(prompt, mod.SamplingParams(max_new_tokens=n), priority=priority,
                         arrival_time=clock.t)
        order[cr.request_id] = len(order)
        return cr

    off, on = mod.Priority.OFFLINE, mod.Priority.ONLINE
    reqs = [submit(a, 30, off), submit(b, 24, off)]
    steps = []
    for n in range(80):
        if n == 1:
            reqs.append(submit(c, 6, on))
        if n == 5:
            reqs.append(submit(d, 5, off))
        grant = mod.Grant(token_budget=40 if n < 2 else float("inf"))
        steps.append(_normalize(core.step(grant), order))
        clock.t += 0.01
        if n >= 5 and not core.has_unfinished:
            break
    assert not core.has_unfinished
    streams = [(list(r.output_tokens), r.finish_reason, r.preemptions) for r in reqs]
    m = eng.obs.metrics
    counters = {name: m.counter(name).value for name in COUNTERS}
    return steps, streams, counters


ENGINE_CASES = [
    # (kv_page_size, prefill_chunk, proposer)
    (0, None, None), (0, None, "draft"), (0, None, "ngram"),
    (0, 0, None), (0, 0, "draft"), (0, 0, "ngram"),
    (None, 0, None),  # paged, monolithic: the radix hit takes the suffix prefill
]


@pytest.fixture(scope="module")
def plain_streams():
    return [s for s, _, _ in _serve("torch", None)[1]]


@pytest.mark.parametrize("case", ENGINE_CASES,
                         ids=lambda c: f"page{c[0]}-chunk{c[1]}-{c[2] or 'plain'}")
def test_engine_core_matches_reference(case, plain_streams):
    page, chunk, proposer = case
    kw = dict(kv_page_size=page, prefill_chunk=chunk)
    jsteps, jstreams, jcounters = _serve("jax", proposer, **kw)
    tsteps, tstreams, tcounters = _serve("torch", proposer, **kw)
    assert tstreams == jstreams
    assert len(tsteps) == len(jsteps)
    for n, (t, j) in enumerate(zip(tsteps, jsteps)):
        assert t == j, f"step {n}"
    assert tcounters == jcounters
    assert [s for s, _, _ in tstreams] == plain_streams
    assert all(reason == "length" for _, reason, _ in tstreams)
    assert any(p for _, _, p in tstreams)  # a preempted request resumed
    if proposer is not None:
        assert tcounters["engine/spec_rounds"] > 0
    if page is None:
        assert tcounters["engine/prefill_skipped_tokens"] > 0  # the radix hit


@pytest.mark.parametrize("page", [0, None], ids=["dense", "paged"])
def test_bucket_len_matches_reference(page):
    """Monolithic buckets: powers of two from the smallest bucket (a page
    when paged), capped at max_seq (paged: at max_seq rounded up to a page;
    a dense consumer on a paged engine, the draft, caps at max_seq)."""
    jeng = _engine("jax", None, Clock(), kv_page_size=page, prefill_chunk=0)
    teng = _engine("torch", None, Clock(), kv_page_size=page, prefill_chunk=0)
    for n in range(1, MAX_SEQ + 2):
        for aligned in (None, False):
            assert teng._bucket_len(n, aligned) == jeng._bucket_len(n, aligned), (n, aligned)


def test_auto_dispatch_counts_and_cuda_raises_on_cpu():
    """The plain versions of #6, #8 and #10 run for CPU tensors (counted);
    asking for the kernel on CPU tensors raises."""
    qc = torch.zeros((2, 3, 4, 16))
    kv = torch.zeros((2, 8, 2, 16))
    lens = torch.tensor([3, 8], dtype=torch.int32)
    anc = torch.tensor([[1, 3, 7]] * 2, dtype=torch.int32)
    xi, b_ = torch.zeros((1, 64, 32)), torch.zeros((1, 64, 8))
    a, h0 = torch.zeros((32, 8)), torch.zeros((1, 32, 8))
    calls = {
        "verify_attention": lambda impl: ops.verify_attention(qc, kv, kv, lens, impl=impl),
        "tree_verify_attention": lambda impl: ops.tree_verify_attention(
            qc, kv, kv, lens, anc, impl=impl),
        "ssm_scan": lambda impl: ops.ssm_scan_chunk(xi, xi, b_, b_, a, h0, impl=impl)[0],
    }
    ops.reset_launch_counts()
    for name, call in calls.items():
        assert torch.equal(call("auto"), call("torch"))
        assert ops.launch_counts()[name] == {"cuda": 0, "torch": 2}
        with pytest.raises(ValueError, match="CUDA"):
            call("cuda")
    ops.reset_launch_counts()
    assert all(c == {"cuda": 0, "torch": 0} for c in ops.launch_counts().values())
