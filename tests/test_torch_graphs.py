"""The engine's serving programs, which the card replays as CUDA graphs, on
the CPU: what would break a capture, the prefill program counts against the
reference engine's, the bucket and suffix prefills with device ``slot`` /
length arguments, and the sync-free dense chunk write.

(a) Every program the engine hands to ``InferenceEngine._program`` (the
chunk wave of the target on both layouts and of the draft, the greedy spec
loop, the bucket and suffix prefills, the decode loop on both layouts, the
n-gram lookup's tree round greedy and simulated on both layouts,
``decode_microstep``'s step on both layouts and the recurrent smokes) runs
under a ``TorchDispatchMode`` that records host syncs and data-dependent
shapes (``aten._local_scalar_dense``, ``nonzero``, ``masked_select``,
``is_nonzero``, ``unique``, ``repeat_interleave`` without a size, a
boolean-mask ``index`` / ``index_put_``, and ``lift_fresh``: host data
turned into a tensor inside the program); none may occur.  The kernels'
plain versions are not recorded: on the card the hand-written kernel runs
in their place.  Smokes of qwen3-1.7b, moonshot-v1-16b-a3b, falcon-mamba-7b,
zamba2-2.7b and musicgen-large (its embedding inputs).

(b) ``prefill_compile_counts()`` equals the reference engine's on the
request sequences of the reference's own count checks (its chunked-prefill
streams over dense / paged x plain / spec x monolithic and chunks of 8 / 16
/ 24, its bucket bound, its micro benchmark's 20 lengths).  The reference's
counts come from its admission and wave logic (``_bucket_buf`` and the
chunk waves record them); its compiled programs are replaced by stubs that
return the cache, so no XLA program is compiled for the count.

(c) ``prefill_into_slot`` / ``prefill_into_slot_paged`` /
``prefill_suffix_into_slot`` with 0-d int32 tensors for the slot and the
lengths: bit-equal to the same calls with Python ints, and within 1e-5 of
the reference (of each leaf's largest magnitude where it passes 1; tokens
and index equal) at every slot and at lengths on and across bucket edges.

(d) ``layers.dense_kv_write_dropped`` equals the reference's
``.at[rows, pos].set(mode="drop")`` bit for bit, with invalid rows,
positions past the end and negative positions.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.configs.base import draft_config as jdraft_config
from repro.models import transformer as JT
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SpecDecodeConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving import core as tserving
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.engine import Request as TRequest

ATOL = 1e-5
aten = torch.ops.aten


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


# ---------------------------------------------------------------------------
# (a) nothing in a captured program syncs the host or shapes from data
# ---------------------------------------------------------------------------

#: ops that read device data on the host or size a tensor from it
_SYNCS = {aten._local_scalar_dense, aten.nonzero, aten.masked_select, aten.is_nonzero,
          aten._unique2, aten.unique_dim, aten.unique_consecutive, aten.lift_fresh}
_INDEXED = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}


class HostSyncs(TorchDispatchMode):
    """Records every host sync or data-dependent shape while active and
    not ``paused`` (inside a kernel entry point)."""

    def __init__(self):
        super().__init__()
        self.events: list = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            op = func.overloadpacket
            if op in _SYNCS:
                self.events.append(str(func))
            elif op is aten.repeat_interleave and kwargs.get("output_size") is None:
                self.events.append(str(func))
            elif op in _INDEXED and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in (args[1] or ()) if i is not None):
                self.events.append(f"{func} with a boolean mask")
        return func(*args, **kwargs)


#: the kernel entry points: on the card the hand-written kernel runs there
_ENTRY_POINTS = ("attention", "paged_decode_attention", "paged_prefill_chunk_attention",
                 "decode_attention", "decode_attention_partial", "combine_decode_partials",
                 "prefill_chunk_attention", "paged_verify_attention",
                 "paged_tree_verify_attention", "verify_attention", "tree_verify_attention",
                 "ssm_scan_chunk")


@contextlib.contextmanager
def _recorded_programs(monkeypatch):
    """Run every engine program under ``HostSyncs``; yields
    ``{program kind: [events]}``."""
    seen: dict = {}
    mode_box: list = []

    def paused(real):
        def call(*a, **kw):
            if mode_box:
                mode_box[-1].paused += 1
            try:
                return real(*a, **kw)
            finally:
                if mode_box:
                    mode_box[-1].paused -= 1
        return call

    for name in _ENTRY_POINTS:
        monkeypatch.setattr(ops, name, paused(getattr(ops, name)))
    real_program = TEngine._program

    def program(self, key, fn, inputs, **kw):
        mode = HostSyncs()
        mode_box.append(mode)
        try:
            with mode:
                out = real_program(self, key, fn, inputs, **kw)
        finally:
            mode_box.pop()
        kind = f"{key[0]}/{key[1]}" if key[0] in ("chunk", "bucket", "suffix") else key[0]
        seen.setdefault(kind, []).extend(mode.events)
        return out

    monkeypatch.setattr(TEngine, "_program", program)
    yield seen


def _smoke(arch, seed=0):
    cfg = configs.smoke_config(arch)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(seed))


def _serve(engine, prompts, max_new=4):
    reqs = [engine.core.submit(p, tserving.SamplingParams(max_new_tokens=max_new))
            for p in prompts]
    guard = 200
    while engine.core.has_unfinished and guard:
        engine.core.step()
        guard -= 1
    assert all(len(r.output_tokens) == max_new for r in reqs)


def _serve_microsteps(engine, prompts, max_new=4):
    """Admit ``prompts`` (prefilled to the end), then ``decode_microstep``
    until every request has its ``max_new`` tokens."""
    reqs = [TRequest(prompt=p, max_new_tokens=max_new) for p in prompts]
    assert all(engine._admit_request(r) for r in reqs)
    engine._drive_prefill_chunks()
    guard = 50
    while engine.num_active and guard:
        engine.decode_microstep()
        guard -= 1
    assert all(len(r.generated) == max_new for r in reqs)


def _prompts(vocab, lengths, shared=0, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, shared)
    return [np.concatenate([prefix, rng.integers(1, vocab, n - shared)]).astype(np.int32)
            for n in lengths]


#: (arch, engine settings, draft paired, prompt lengths, shared prefix,
#: programs it must run: kind, and model for the prefills)
#: a host proposer in place of the draft (a tree round per proposal)
NGRAM = SpecDecodeConfig(proposer="ngram")
NGRAM_SIM = SpecDecodeConfig(proposer="ngram", mode="simulated")
CHUNK, DRAFT_CHUNK = "chunk/target", "chunk/draft"
BUCKET, DRAFT_BUCKET, SUFFIX = "bucket/target", "bucket/draft", "suffix/target"
CAPTURE_CASES = [
    ("qwen3-1.7b", {}, False, (21, 9, 40), 0, {CHUNK, "decode"}),
    ("qwen3-1.7b", {}, True, (21, 9, 40), 0, {CHUNK, DRAFT_CHUNK, "spec"}),
    ("qwen3-1.7b", {"kv_page_size": 0}, True, (21, 9, 40), 0, {CHUNK, DRAFT_CHUNK, "spec"}),
    ("qwen3-1.7b", {"kv_page_size": 0}, False, (21, 9), 0, {CHUNK, "decode"}),
    ("qwen3-1.7b", {"prefill_chunk": 0}, True, (40, 37, 37), 32,
     {BUCKET, SUFFIX, DRAFT_BUCKET, "spec"}),
    ("qwen3-1.7b", {"prefill_chunk": 0}, False, (40, 37, 37), 32, {BUCKET, SUFFIX, "decode"}),
    ("qwen3-1.7b", {"kv_page_size": 0, "prefill_chunk": 0}, False, (13, 30), 0,
     {BUCKET, "decode"}),
    ("moonshot-v1-16b-a3b", {}, False, (21, 9), 0, {CHUNK, "decode"}),
    ("moonshot-v1-16b-a3b", {"kv_page_size": 0, "prefill_chunk": 0}, False, (13, 30), 0,
     {BUCKET, "decode"}),
    ("falcon-mamba-7b", {}, False, (13, 30), 0, {BUCKET, "decode"}),
    ("falcon-mamba-7b", {}, True, (13, 30), 0, {BUCKET, DRAFT_BUCKET, "spec"}),
    ("zamba2-2.7b", {}, False, (13, 30), 0, {BUCKET, "decode"}),
    # the stub frontend's embedding rows fed inside the bucket program
    ("musicgen-large", {"prefill_chunk": 0}, True, (13, 30), 0, {BUCKET, DRAFT_BUCKET, "spec"}),
    # the host-proposed tree round (n-gram lookup over prompts that repeat)
    ("qwen3-1.7b", {}, NGRAM, (21, 9, 40), 0, {CHUNK, "tree"}),
    ("qwen3-1.7b", {}, NGRAM_SIM, (21, 9, 40), 0, {CHUNK, "tree"}),
    ("qwen3-1.7b", {"kv_page_size": 0}, NGRAM, (21, 9, 40), 0, {CHUNK, "tree"}),
    ("qwen3-1.7b", {"kv_page_size": 0}, NGRAM_SIM, (21, 9, 40), 0, {CHUNK, "tree"}),
    # ``decode_microstep``'s single step
    ("qwen3-1.7b", {}, False, (21, 9, 40), 0, {CHUNK, "step"}),
    ("qwen3-1.7b", {"kv_page_size": 0}, False, (21, 9), 0, {CHUNK, "step"}),
    ("falcon-mamba-7b", {}, False, (13, 30), 0, {BUCKET, "step"}),
    ("zamba2-2.7b", {}, False, (13, 30), 0, {BUCKET, "step"}),
]


@pytest.mark.parametrize("arch,layout,draft,lengths,shared,kinds", CAPTURE_CASES)
def test_engine_programs_never_sync_the_host(arch, layout, draft, lengths, shared, kinds,
                                             monkeypatch):
    cfg, params = _smoke(arch)
    kw = dict(layout)
    prompts = _prompts(cfg.vocab_size, lengths, shared)
    if isinstance(draft, SpecDecodeConfig):
        # a host proposer: prompts of a repeating 5-token period, so the
        # n-gram lookup proposes
        kw["spec"] = draft
        prompts = [np.resize(p[:5], len(p)) for p in prompts]
    elif draft:
        dcfg = configs.draft_config(cfg)
        kw.update(draft_cfg=dcfg, draft_params=T.init_params(dcfg, torch.Generator().manual_seed(1)),
                  spec=SpecDecodeConfig(proposer="draft"))
    engine = TEngine(cfg, params, compute_dtype=torch.float32, device="cpu", max_slots=4,
                     max_seq=64, **kw)
    with _recorded_programs(monkeypatch) as seen:
        if "step" in kinds:
            _serve_microsteps(engine, prompts)
        else:
            _serve(engine, prompts, max_new=8 if "tree" in kinds else 4)
    assert kinds <= set(seen), sorted(seen)
    assert {kind: events for kind, events in seen.items() if events} == {}
    if "suffix" in kinds:
        assert engine.prefill_skipped_tokens > 0


def test_the_recorder_sees_what_would_break_a_capture():
    """The mode records the host syncs of the old dense chunk write (a
    boolean selection) and of ``int`` on a tensor, and nothing in the new
    write."""
    cache = torch.zeros((2, 8, 1, 4))
    new = torch.ones((2, 3, 1, 4))
    pos = torch.tensor([[0, 1, 2], [6, 7, 8]])
    valid = torch.tensor([[True, True, False], [True, True, True]])
    with HostSyncs() as mode:
        keep = valid & (pos < 8)
        rows = torch.arange(2)[:, None].expand_as(keep)
        cache[rows[keep], pos[keep]] = new[keep]
        int(pos[0, 0])
    assert any("boolean" in e for e in mode.events)
    assert any("_local_scalar_dense" in e for e in mode.events)
    with HostSyncs() as mode:
        L.dense_kv_write_dropped(cache, new, pos, valid)
    assert mode.events == []


# ---------------------------------------------------------------------------
# (b) prefill program counts, against the reference engine's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smokes():
    """Reference and port weights of the two smokes the counts run on."""
    out = {}
    for arch, seed in (("qwen3-1.7b", 0), ("olmo-1b", 0)):
        jcfg = jconfigs.smoke_config(arch)
        np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(seed)))
        out[arch] = (jcfg, configs.smoke_config(arch), np_params)
    jcfg = jconfigs.smoke_config("qwen3-1.7b")
    jd = jdraft_config(jcfg)
    np_d = jax.tree.map(np.array, JT.init_params(jd, jax.random.PRNGKey(5)))
    out["draft"] = (jd, configs.draft_config(configs.smoke_config("qwen3-1.7b")), np_d)
    return out


def _stub_reference_programs(eng):
    """The reference engine's compiled programs as stubs that return the
    cache: its admission and waves still record every prefill program."""
    zero = jnp.int32(0)
    eng._prefill_slot = lambda params, buf, n, slot, cache: (zero, cache)
    eng._suffix_prefill = lambda params, buf, n, shared, slot, cache: (zero, cache)
    eng._draft_prefill = lambda params, buf, n, slot, cache: (zero, cache)
    eng._prefill_chunks = lambda params, toks, lens, cache: (
        jnp.zeros((eng.max_slots,), jnp.int32), cache)
    eng._draft_prefill_chunks = lambda params, toks, lens, cache: (
        jnp.zeros((eng.max_slots,), jnp.int32), cache)


def _engines(smokes, arch, draft=False, **kw):
    jcfg, cfg, np_params = smokes[arch]
    jkw, tkw = dict(kw), dict(kw)
    if draft:
        jd, td, np_d = smokes["draft"]
        jkw.update(draft_cfg=jd, draft_params=jax.tree.map(jnp.asarray, np_d),
                   compute_dtype=jnp.float32)
        tkw.update(draft_cfg=td, draft_params=params_from_numpy(np_d, device="cpu"),
                   compute_dtype=torch.float32)
    else:
        tkw["compute_dtype"] = torch.float32
    ref = JEngine(jcfg, jax.tree.map(jnp.asarray, np_params), **jkw)
    _stub_reference_programs(ref)
    port = TEngine(cfg, params_from_numpy(np_params, device="cpu"), device="cpu", **tkw)
    return ref, port


def _admit(ref, port, prompt, recycle=False):
    """Admit ``prompt`` into both engines (the port streams its chunks to the
    end, as the reference's admission does); ``recycle`` first drops every
    slot the reference's benchmark way."""
    for eng in (ref, port):
        if recycle:
            eng.slots = [None] * eng.max_slots
            eng._prefill_left = [None] * eng.max_slots
            eng._draft_prefill_left = [None] * eng.max_slots
    ok_ref = ref._admit_request(JRequest(prompt=prompt, max_new_tokens=1))
    ok_port = port._admit_request(TRequest(prompt=prompt, max_new_tokens=1))
    assert ok_ref == ok_port
    port._drive_prefill_chunks()


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("chunk", [0, 8, 16, 24])
def test_counts_match_reference_on_the_chunked_prefill_streams(smokes, paged, spec, chunk):
    """The reference's chunked-prefill stream check: four ragged prompts
    (33 crosses two pages, 47 ends mid-page), monolithic (a radix hit's
    suffix prefill on the paged layout) or chunked."""
    ref, port = _engines(smokes, "qwen3-1.7b", spec, max_slots=4, max_seq=64,
                         kv_page_size=None if paged else 0, prefill_chunk=chunk)
    for n in (5, 17, 33, 47):
        _admit(ref, port, np.arange(1, n + 1))
    assert port.prefill_compile_counts() == ref.prefill_compile_counts()
    assert port.prefill_compile_count == ref.prefill_compile_count
    if chunk:
        assert port.prefill_compile_counts()["target/chunk"] == 1
    assert port.prefill_graph_count == 0  # nothing is captured on the CPU


@pytest.mark.parametrize("chunk", [None, 0])
def test_counts_match_reference_on_the_bucket_bound(smokes, chunk):
    """The reference's bucket bound: olmo-1b, one slot, eight lengths into
    buckets {8, 16, 32} (one chunk program when chunked)."""
    ref, port = _engines(smokes, "olmo-1b", max_slots=1, max_seq=64, prefill_chunk=chunk)
    for n in (3, 5, 7, 8, 9, 15, 17, 30):
        _admit(ref, port, np.arange(n), recycle=True)
    assert port.prefill_compile_counts() == ref.prefill_compile_counts()
    assert port.prefill_compile_count == ref.prefill_compile_count


@pytest.mark.parametrize("chunk", [None, 0], ids=["chunked", "bucketed"])
def test_counts_match_reference_on_the_micro_benchmarks_20_lengths(smokes, chunk):
    """The reference micro benchmark's ``prefill_buckets`` row: 20 prompt
    lengths (3 .. 22) through qwen3-1.7b at max_seq 128, four slots
    recycled."""
    ref, port = _engines(smokes, "qwen3-1.7b", max_slots=4, max_seq=128, prefill_chunk=chunk)
    for n in range(3, 23):
        _admit(ref, port, np.arange(n), recycle=True)
    assert port.prefill_compile_counts() == ref.prefill_compile_counts()
    assert port.prefill_compile_count == ref.prefill_compile_count
    if chunk is None:
        assert port.prefill_compile_counts() == {"target/chunk": 1}


# ---------------------------------------------------------------------------
# (c) bucket and suffix prefills with device slot and lengths
# ---------------------------------------------------------------------------


def _i32(n):
    return torch.tensor(n, dtype=torch.int32)


def _same(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b", "zamba2-2.7b"])
def test_tensor_argument_bucket_prefill_matches_int_and_reference(smokes, arch):
    """Every slot of a 3-slot dense cache, at lengths on and across the 8 /
    16 bucket edges: the row written, the index and the first token."""
    jcfg = jconfigs.smoke_config(arch)
    cfg = configs.smoke_config(arch)
    np_params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(np_params, device="cpu")
    jp = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(3)
    max_seq = 32
    jc = JT.init_cache(jcfg, 3, max_seq, jnp.float32)
    jc["index"] = jnp.zeros((3,), jnp.int32)
    tc = T.init_cache(cfg, 3, max_seq, torch.float32, "cpu")
    ic = T.init_cache(cfg, 3, max_seq, torch.float32, "cpu")
    for slot, (n, sb) in enumerate(((8, 8), (9, 16), (16, 16))):
        buf = np.zeros((1, sb), np.int32)
        buf[0, :n] = rng.integers(1, cfg.vocab_size, n)
        tok_j, jc = JT.prefill_into_slot(jcfg, jp, jnp.asarray(buf), jnp.int32(n),
                                         jnp.int32(slot), jc, max_seq=max_seq, impl="xla",
                                         compute_dtype=jnp.float32)
        tok_t, tc = T.prefill_into_slot(cfg, params, _t(buf), _i32(n), _i32(slot), tc,
                                        max_seq=max_seq, impl="torch",
                                        compute_dtype=torch.float32)
        tok_i, ic = T.prefill_into_slot(cfg, params, _t(buf), n, slot, ic, max_seq=max_seq,
                                        impl="torch", compute_dtype=torch.float32)
        assert int(tok_t) == int(tok_i) == int(tok_j)
        _same(tc["layers"], ic["layers"])
        for port, ref in zip(jax.tree.leaves(tc["layers"]), jax.tree.leaves(jc["layers"])):
            ref = np.asarray(ref)  # 1e-5 of the leaf's scale (the SSM state reaches ~3)
            np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                                       atol=ATOL * max(1.0, np.abs(ref).max()))
    assert tc["index"].tolist() == ic["index"].tolist() == np.asarray(jc["index"]).tolist() == [
        8, 9, 16]


def test_tensor_argument_paged_and_suffix_prefill_match_int_and_reference(smokes):
    """A 16-token prompt (on the 16 edge) into slot 0 and a 17-token one
    (across it, bucket 32) into slot 1, then slot 2 shares slot 1's first
    page and prefills its 8-token suffix."""
    jcfg, cfg, np_params = smokes["qwen3-1.7b"]
    params = params_from_numpy(np_params, device="cpu")
    jp = jax.tree.map(jnp.asarray, np_params)
    page, per_slot, b = 16, 3, 3
    bt = np.zeros((b, per_slot + 1), np.int32)
    bt[0, :1] = [5]
    bt[1, :2] = [2, 7]
    bt[2, :2] = [2, 4]  # slot 2 shares slot 1's first page
    jc = JT.init_paged_cache(jcfg, b, b * per_slot + 1, page, per_slot, jnp.float32)
    jc["block_tables"] = jnp.asarray(bt)
    caches = [T.init_paged_cache(cfg, b, b * per_slot + 1, page, per_slot, torch.float32, "cpu")
              for _ in range(2)]
    for c in caches:
        c["block_tables"] = _t(bt)
    rng = np.random.default_rng(4)
    for slot, (n, sb) in enumerate(((16, 16), (17, 32))):
        buf = np.zeros((1, sb), np.int32)
        buf[0, :n] = rng.integers(1, cfg.vocab_size, n)
        tok_j, jc = JT.prefill_into_slot_paged(jcfg, jp, jnp.asarray(buf), jnp.int32(n),
                                               jnp.int32(slot), jc, impl="xla",
                                               compute_dtype=jnp.float32)
        toks = []
        for c, args in zip(caches, ((_i32(n), _i32(slot)), (n, slot))):
            tok, _ = T.prefill_into_slot_paged(cfg, params, _t(buf), *args, c, impl="torch",
                                               compute_dtype=torch.float32)
            toks.append(int(tok))
        assert toks == [int(tok_j)] * 2
    sbuf = np.zeros((1, 8), np.int32)
    sbuf[0, :8] = rng.integers(1, cfg.vocab_size, 8)
    suf_j, jc = JT.prefill_suffix_into_slot(jcfg, jp, jnp.asarray(sbuf), jnp.int32(8),
                                            jnp.int32(16), jnp.int32(2), jc,
                                            compute_dtype=jnp.float32, attn_impl="xla")
    toks = []
    for c, args in zip(caches, ((_i32(8), _i32(16), _i32(2)), (8, 16, 2))):
        tok, _ = T.prefill_suffix_into_slot(cfg, params, _t(sbuf), *args, c,
                                            compute_dtype=torch.float32, attn_impl="torch")
        toks.append(int(tok))
    assert toks == [int(suf_j)] * 2
    _same(caches[0], caches[1])
    assert caches[0]["index"].tolist() == np.asarray(jc["index"]).tolist() == [16, 17, 24]
    live = [2, 4, 5, 7]
    for name in ("k", "v"):
        np.testing.assert_allclose(caches[0]["layers"][name][:, live].numpy(),
                                   np.asarray(jc["layers"][name])[:, live], rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# (d) the sync-free dense chunk write keeps the reference's drop rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_dense_drop_write_equals_reference_scatter(seed):
    """Random starts from -10 to past the end, a random mask of valid rows
    (slots with no valid row included): every entry equals JAX's scatter
    with ``mode="drop"``, bit for bit."""
    rng = np.random.default_rng(seed)
    b, c, s = 5, 6, 9
    for _ in range(8):
        cache = rng.standard_normal((b, s, 2, 4)).astype(np.float32)
        new = rng.standard_normal((b, c, 2, 4)).astype(np.float32)
        starts = rng.integers(-10, s + 3, (b,))
        pos = (starts[:, None] + np.arange(c)[None]).astype(np.int32)
        valid = rng.random((b, c)) < 0.6
        valid[0] = False  # a slot that writes nothing
        rows = np.broadcast_to(np.arange(b)[:, None], (b, c))
        want = jnp.asarray(cache).at[rows, np.where(valid, pos, s)].set(
            jnp.asarray(new), mode="drop")
        got = _t(cache.copy())
        L.dense_kv_write_dropped(got, _t(new), _t(pos), _t(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
