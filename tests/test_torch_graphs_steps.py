"""The last compiled programs of the reference that the card replays as CUDA
graphs, on the CPU: the serve steps (``ServeStepArtifacts.jitted``),
``make_collocated_step``'s decode chain and the engine's tree round
(``InferenceEngine._tree_round_fn``).

(a) The serve steps' prefill and decode (``art.step``) on a one-rank gloo
mesh, for the qwen3-1.7b, moonshot-v1-16b-a3b, falcon-mamba-7b and
zamba2-2.7b smokes, an 8-bit cache and ``fsdp=True``, and the collocated
chain, run under ``tests/test_torch_graphs.py``'s ``HostSyncs``: no host
sync, no data-dependent shape, no host data turned into a tensor (the
kernel entry points not recorded: the card runs the kernel there).  The
engine's tree round and ``decode_microstep`` are cases of that file's
``CAPTURE_CASES``.

(b) The port's ``_tree_round_fn(parents, "greedy")`` on a fp32 qwen3 smoke
engine, paged and dense, for a linear chain and a branching tree, against
the reference engine's ``_tree_round_fn`` on the same weights
(``bridge.params_from_numpy``), the same prompts and the same tails:
tokens, ``out``, ``n_out``, accepted, proposed, remaining, the NaN screen
and the index equal, the cache within 1e-5 (of each leaf's largest
magnitude where it passes 1).

(c) ``jitted()`` on the CPU: ``step``'s outputs bit for bit;
``donate_cache=False`` raises ``NotImplementedError`` on the decode step.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.configs.base import SpecDecodeConfig as JSpec
from repro.models import transformer as JT
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SpecDecodeConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import make_collocated_step
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as T
from repro_torch.runtime import make_prefill_step, make_serve_step
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.spec import tree as spec_tree
from repro_torch.tree import tree_leaves, tree_map
from test_torch_graphs import _ENTRY_POINTS, HostSyncs

ATOL = 1e-5
SEQ, ROWS, PROMPT, DECODES = 32, 2, 12, 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def one_rank_mesh(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _recording(monkeypatch):
    """``HostSyncs`` over the block, paused inside the kernel entry points."""
    mode = HostSyncs()

    def paused(real):
        def call(*a, **kw):
            mode.paused += 1
            try:
                return real(*a, **kw)
            finally:
                mode.paused -= 1
        return call

    for name in _ENTRY_POINTS:
        monkeypatch.setattr(ops, name, paused(getattr(ops, name)))
    with mode:
        yield mode


def _smoke(arch, seed=0):
    cfg = configs.smoke_config(arch)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(seed))


def _steps(cfg, mesh, **kw):
    shape = ShapeConfig("graphs", SEQ, ROWS, "decode")
    kw = dict(compute_dtype=torch.float32, **kw)
    return make_prefill_step(cfg, mesh, shape, **kw), make_serve_step(cfg, mesh, shape, **kw)


def _prompt_rows(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(1, cfg.vocab_size, (ROWS, PROMPT), generator=gen, dtype=torch.int32)


# ---------------------------------------------------------------------------
# (a) the serve steps and the collocated chain never sync the host
# ---------------------------------------------------------------------------

SERVE_STEP_CASES = [
    ("qwen3-1.7b", {}),
    ("moonshot-v1-16b-a3b", {}),
    ("falcon-mamba-7b", {}),
    ("zamba2-2.7b", {}),
    ("qwen3-1.7b", {"cache_dtype": torch.float8_e4m3fn}),
    ("qwen3-1.7b", {"fsdp": True}),
]


@pytest.mark.parametrize("arch,kw", SERVE_STEP_CASES,
                         ids=["qwen3", "moonshot", "falcon-mamba", "zamba2", "fp8", "fsdp"])
def test_serve_steps_never_sync_the_host(arch, kw, one_rank_mesh, monkeypatch):
    cfg, params = _smoke(arch)
    pre, dec = _steps(cfg, one_rank_mesh, **kw)
    local = pre.shard_params(params)
    inputs = pre.shard_inputs(_prompt_rows(cfg))
    with _recording(monkeypatch) as mode:
        logits, cache = pre.step(local, inputs)
    assert mode.events == []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    with _recording(monkeypatch) as mode:
        for _ in range(DECODES):
            tok, cache = dec.step(local, tok, cache)
    assert mode.events == []
    assert int(cache["index"]) == PROMPT + DECODES


def test_collocated_chain_never_syncs_the_host(monkeypatch):
    """The chain ``make_collocated_step`` graphs: k greedy ``T.decode_step``
    of the qwen3 smoke over dense rows (the train step a stand-in, eager on
    the card)."""
    cfg, params = _smoke("qwen3-1.7b")
    cache = T.init_cache(cfg, ROWS, SEQ, torch.float32, "cpu")
    cache["index"] = torch.tensor([5, 9], dtype=torch.int32)

    def decode(p, t, c):
        return T.decode_step(cfg, p, t, c, compute_dtype=torch.float32)

    fused = make_collocated_step(lambda state, batch: (state, {}), decode, k_buckets=(0, 2))
    tokens = torch.tensor([1, 2], dtype=torch.int32)
    with _recording(monkeypatch) as mode:
        _, _, toks, cache = fused[2]({}, {}, params, tokens, cache)
    assert mode.events == []
    assert cache["index"].tolist() == [7, 11]
    assert fused[0].graphs is None and fused[2].graphs.captures == 0  # nothing on the CPU


# ---------------------------------------------------------------------------
# (b) the tree round's program against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen_weights():
    jcfg = jconfigs.smoke_config("qwen3-1.7b")
    return jcfg, jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))


def _engines(qwen_weights, paged):
    jcfg, np_params = qwen_weights
    kw = dict(max_slots=4, max_seq=64, kv_page_size=None if paged else 0, prefill_chunk=0)
    ref = JEngine(jcfg, jax.tree.map(jnp.asarray, np_params), compute_dtype=jnp.float32,
                  spec=JSpec(proposer="ngram"), **kw)
    port = TEngine(configs.smoke_config("qwen3-1.7b"), params_from_numpy(np_params, device="cpu"),
                   compute_dtype=torch.float32, device="cpu",
                   spec=SpecDecodeConfig(proposer="ngram"), **kw)
    rng = np.random.default_rng(35)
    for n in (13, 21, 9):
        prompt = rng.integers(1, jcfg.vocab_size, n).astype(np.int32)
        assert ref._admit_request(JRequest(prompt=prompt, max_new_tokens=8))
        assert port._admit_request(TRequest(prompt=prompt, max_new_tokens=8))
    assert port.tokens.tolist() == np.asarray(ref.tokens).tolist()
    return ref, port


def _greedy(port, steps):
    """[steps, B] greedy continuation of every slot, from a copy of the
    port's cache."""
    cache = tree_map(lambda t: t.clone(), port.cache)
    loop = T.decode_loop(port.cfg, port.params, port.tokens.clone(), cache, k=steps,
                         max_seq=port.max_seq, compute_dtype=torch.float32, attn_impl="torch")
    return loop[3].numpy()


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))


TREES = {"chain": spec_tree.linear_chain(3), "branching": spec_tree.branching_tree(2, 2)}


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_tree_round_fn_matches_reference(qwen_weights, paged, tree):
    parents = TREES[tree]
    ref, port = _engines(qwen_weights, paged)
    n = len(parents)
    if paged:
        for eng in (ref, port):
            eng._top_up_pages(n)
        assert port.cache["block_tables"].tolist() == np.asarray(ref.cache["block_tables"]).tolist()
    greedy = _greedy(port, n)
    rng = np.random.default_rng(7)
    tail = rng.integers(1, port.cfg.vocab_size, (port.max_slots, n - 1)).astype(np.int32)
    if tree == "chain":
        tail[0] = greedy[: n - 1, 0]  # slot 0 accepts the whole chain
        tail[1, 0] = greedy[0, 1]  # slot 1 its first node
    else:
        # slot 0: branch 1 wrong at its first node, branch 2 the greedy
        # chain; slot 1: branch 1 the greedy chain
        tail[0, 0] = (greedy[0, 0] + 1) % port.cfg.vocab_size
        tail[0, 2:] = greedy[:2, 0]
        tail[1, :2] = greedy[:2, 1]
    rem = np.asarray([6, 2, 5, 0], np.int32)
    jres = ref._tree_round_fn(parents, "greedy")(
        ref.params, ref.tokens, ref.cache, jnp.asarray(tail), jnp.asarray(rem), ref._spec_key)
    inputs = port._cache_inputs(port.cache, tokens=port.tokens, tail=torch.tensor(tail),
                                remaining=torch.tensor(rem))
    tres = port._tree_round_fn(parents, "greedy")(inputs)
    assert port._tree_round_fn(parents, "greedy") is port._tree_round_fn(parents, "greedy")
    # port: tokens, index, remaining, out, n_out, accepted, proposed, bad
    # reference: tokens, cache, remaining, key, out, n_out, accepted, proposed, bad
    jcache = jres[1]
    for got, want in zip(tres[:1] + tres[2:], jres[:1] + jres[2:3] + jres[4:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tres[1].numpy(), np.asarray(jcache["index"]))
    accepted = tres[5].tolist()
    assert accepted[0] == (n - 1 if tree == "chain" else 2) and accepted[1] >= 1
    for name in ("k", "v"):
        got, want = port.cache["layers"][name], np.asarray(jcache["layers"][name])
        if paged:  # the sentinel page takes colliding pad writes
            got, want = got[:, 1:], want[:, 1:]
        _close(got, want)


# ---------------------------------------------------------------------------
# (c) ``jitted()`` on the CPU
# ---------------------------------------------------------------------------


def test_jitted_on_the_cpu_is_the_step(one_rank_mesh):
    cfg, params = _smoke("qwen3-1.7b")
    pre, dec = _steps(cfg, one_rank_mesh)
    local = pre.shard_params(params)
    inputs = pre.shard_inputs(_prompt_rows(cfg))
    (l_step, c_step), (l_jit, c_jit) = pre.step(local, inputs), pre.jitted()(local, inputs)
    assert torch.equal(l_step, l_jit)
    for a, b in zip(tree_leaves(c_step), tree_leaves(c_jit)):
        assert torch.equal(a, b)
    tok = torch.argmax(l_step, dim=-1).to(torch.int32)
    jitted = dec.jitted()
    t_step, t_jit = tok, tok.clone()
    for _ in range(DECODES):
        t_step, c_step = dec.step(local, t_step, c_step)
        t_jit, c_jit = jitted(local, t_jit, c_jit)
        assert torch.equal(t_step, t_jit)
    for a, b in zip(tree_leaves(c_step), tree_leaves(c_jit)):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="in place"):
        dec.jitted(donate_cache=False)
    pre.jitted(donate_cache=False)  # a prefill takes no cache to donate
