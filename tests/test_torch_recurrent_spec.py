"""Port's speculative decoding with a recurrent target and draft (Mamba1:
falcon-mamba-7b; the Zamba2 hybrid: zamba2-2.7b) against the reference, on
the CPU in fp32, at the model level (the engine's runs:
``tests/test_torch_recurrent_spec_engine.py``).

* ``decode_chunk``: equal to T sequential ``decode_step`` calls (logits and
  cache), its last captured state equal to the final one (as
  ``tests/test_spec_decode.py``), and its logits and per-step states
  against the reference's.
* ``rollback_recurrent`` and ``select_step_state`` against the reference's
  on the same stacks (the hybrid's batch on axis 2 of its leaves).
* ``draft_propose`` with a recurrent draft: its per-step state stack and
  tokens against the reference's.
* ``spec_decode_loop`` with a frozen slot: emitted tokens, counts and the
  rolled-back states against the reference's; the frozen slot's state kept
  bit for bit, and the states written back into the cache's own tensors.

Tolerances: logits and states max|d| <= 1e-4 * max|ref| (fp32, sums in
another order); tokens exact.  Weights come from the reference's init
through ``bridge.params_from_numpy``; inputs from numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import draft_config as jdraft_config
from repro.models import transformer as JT
from repro.spec import draft as jdraft
from repro.spec import loop as jloop
from repro.spec import rollback as jrollback
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import draft_config
from repro_torch.models import transformer as T
from repro_torch.spec import draft as tdraft
from repro_torch.spec import loop as tloop
from repro_torch.spec import rollback as trollback
from repro_torch.tree import tree_leaves

ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")
RTOL = 1e-4
MAX_SEQ = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(arch):
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    jdcfg, dcfg = jdraft_config(jcfg), draft_config(cfg)
    params = jax.tree.map(np.array, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    dparams = jax.tree.map(np.array, JT.init_params(jdcfg, jax.random.PRNGKey(7)))
    return jcfg, cfg, jdcfg, dcfg, params, dparams


def _close(port, ref, name=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (name, port.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(port - ref).max())
    assert err <= RTOL * scale, (name, err, scale)


def _tree_close(port, ref, name=""):
    """Leaf by leaf, matched by path (JAX orders a dict's leaves by key)."""
    pf, rf = _flat(port), _flat(ref)
    assert pf.keys() == rf.keys()
    for path, r in rf.items():
        _close(pf[path], r, f"{name}/{path}")


def _caches(jcfg, cfg, np_params, prompt, length):
    """The reference's and the port's caches after prefilling ``prompt``
    [B, n], with a [B] index."""
    b = prompt.shape[0]
    _, jc = JT.prefill(jcfg, jax.tree.map(jnp.asarray, np_params), jnp.asarray(prompt),
                       MAX_SEQ, compute_dtype=jnp.float32)
    jc["index"] = jnp.full((b,), length, jnp.int32)
    _, tc = T.prefill(cfg, params_from_numpy(np_params, device="cpu"),
                      torch.from_numpy(prompt), MAX_SEQ, compute_dtype=torch.float32)
    tc["index"] = torch.full((b,), length, dtype=torch.int32)
    return jc, tc


def _clone(cache):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else
                {n: (t.clone() if isinstance(t, torch.Tensor) else
                     {m: s.clone() for m, s in t.items()}) for n, t in v.items()})
            for k, v in cache.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chunk_matches_sequential_steps_and_reference(arch):
    jcfg, cfg, _, _, np_params, _ = _setup(arch)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    jc, tc = _caches(jcfg, cfg, np_params, prompt, 6)
    params = params_from_numpy(np_params, device="cpu")
    jl, jc_out, jstates = JT.decode_chunk(jcfg, jax.tree.map(jnp.asarray, np_params),
                                          jnp.asarray(toks), jc, compute_dtype=jnp.float32)
    seq = _clone(tc)
    logits, tc, states = T.decode_chunk(cfg, params, torch.from_numpy(toks), tc,
                                        compute_dtype=torch.float32)
    seq_logits = []
    for j in range(4):
        lj, seq = T.decode_step(cfg, params, torch.from_numpy(toks[:, j]), seq,
                                compute_dtype=torch.float32)
        seq_logits.append(lj)
    assert torch.equal(logits, torch.stack(seq_logits, 1))
    assert tc["index"].tolist() == seq["index"].tolist() == [10, 10]
    for a, b in zip(tree_leaves(tc["layers"]), tree_leaves(seq["layers"])):
        assert torch.equal(a, b)
    # per-step capture: the last captured state is the final one
    live = T.chunk_recurrent_states(cfg, tc["layers"])
    for stack, final in zip(tree_leaves(states), tree_leaves(live)):
        assert stack.shape[0] == 4 and torch.equal(stack[-1], final)
    _close(logits, jl, "logits")
    _tree_close(states, jstates, "states")
    assert tc["index"].tolist() == np.asarray(jc_out["index"]).tolist()
    # one position's logits (the suffix prefill's), and no tree mode
    jl1 = T.decode_chunk(cfg, params, torch.from_numpy(toks), _clone(seq), logits_at=9,
                         compute_dtype=torch.float32)[0]
    assert jl1.shape == (2, 1, cfg.vocab_size)
    with pytest.raises(ValueError, match="attention family"):
        T.decode_chunk(cfg, params, torch.from_numpy(toks), seq,
                       anc=torch.ones((2, 4), dtype=torch.int32),
                       depths=torch.arange(4, dtype=torch.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_rollback_recurrent_matches_reference(arch):
    jcfg, cfg, _, _, _, _ = _setup(arch)
    assert T.recurrent_state_batch_axis(cfg) == JT.recurrent_state_batch_axis(jcfg)
    b, steps = 3, 5
    layers = T.init_cache(cfg, b, 8, torch.float32, "cpu")["layers"]
    old = T.chunk_recurrent_states(cfg, layers)
    rng = np.random.default_rng(2)
    np_old = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
              for k, v in _flat(old).items()}
    np_stack = {k: rng.standard_normal((steps, *v.shape)).astype(np.float32)
                for k, v in np_old.items()}
    sel = np.asarray([4, 0, 2], np.int32)
    active = np.asarray([True, True, False])
    nest = lambda flat, conv: _nest(old, flat, conv)
    ref = _flat(jrollback.rollback_recurrent(
        jcfg, nest(np_stack, jnp.asarray), jnp.asarray(sel), jnp.asarray(active),
        nest(np_old, jnp.asarray)))
    got = _flat(trollback.rollback_recurrent(
        cfg, nest(np_stack, torch.from_numpy), torch.from_numpy(sel),
        torch.from_numpy(active), nest(np_old, torch.from_numpy)))
    assert got.keys() == ref.keys() == np_old.keys()
    for path, r in ref.items():
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(r))
    ba = T.recurrent_state_batch_axis(cfg) + 1
    for name, stack in np_stack.items():
        picked = trollback.select_step_state(torch.from_numpy(stack), torch.from_numpy(sel), ba)
        np.testing.assert_array_equal(
            picked.numpy(), np.asarray(jrollback.select_step_state(
                jnp.asarray(stack), jnp.asarray(sel), ba)))
    assert trollback.rollback_recurrent(cfg, None, torch.from_numpy(sel),
                                        torch.from_numpy(active), old) is old


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _nest(like, flat, conv, prefix=""):
    if isinstance(like, dict):
        return {k: _nest(v, flat, conv, f"{prefix}{k}/") for k, v in like.items()}
    return conv(flat[prefix[:-1]])


@pytest.mark.parametrize("arch", ARCHS)
def test_draft_propose_captures_every_step(arch):
    _, _, jdcfg, dcfg, _, np_dparams = _setup(arch)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, dcfg.vocab_size, (2, 5)).astype(np.int32)
    jc, tc = _caches(jdcfg, dcfg, np_dparams, prompt, 5)
    tok = np.asarray([3, 7], np.int32)
    jt, _, jc, jstates = jdraft.draft_propose(
        jdcfg, jax.tree.map(jnp.asarray, np_dparams), jnp.asarray(tok), jc, gamma=3,
        compute_dtype=jnp.float32)
    tt, _, tc, tstates = tdraft.draft_propose(
        dcfg, params_from_numpy(np_dparams, device="cpu"), torch.from_numpy(tok), tc,
        gamma=3, compute_dtype=torch.float32)
    assert tt.tolist() == np.asarray(jt).tolist()
    assert all(s.shape[0] == 4 for s in tree_leaves(tstates))
    _tree_close(tstates, jstates, "draft states")
    for stack, final in zip(tree_leaves(tstates),
                            tree_leaves(T.chunk_recurrent_states(dcfg, tc["layers"]))):
        assert torch.equal(stack[-1], final)
        assert not torch.equal(stack[0], stack[-1])  # a stack, not the final state


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_decode_loop_matches_reference(arch):
    jcfg, cfg, jdcfg, dcfg, np_params, np_dparams = _setup(arch)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    jc, tc = _caches(jcfg, cfg, np_params, prompt, 6)
    jd, td = _caches(jdcfg, dcfg, np_dparams, prompt, 6)
    tok = np.asarray([5, 9, 1], np.int32)
    rem = np.asarray([7, 3, 0], np.int32)  # slot 2 frozen, slot 1 runs out
    frozen = [t[:, 2].clone() if T.recurrent_state_batch_axis(cfg) == 1 else t[:, :, 2].clone()
              for t in tree_leaves(T.chunk_recurrent_states(cfg, tc["layers"]))]
    live = tree_leaves(T.chunk_recurrent_states(cfg, tc["layers"]))
    jout = jloop.spec_decode_loop(
        jcfg, jdcfg, jax.tree.map(jnp.asarray, np_params),
        jax.tree.map(jnp.asarray, np_dparams), jnp.asarray(tok), jc, jd, jnp.asarray(rem),
        jax.random.PRNGKey(0), k=3, gamma=2, max_seq=MAX_SEQ, compute_dtype=jnp.float32)
    tout = tloop.spec_decode_loop(
        cfg, dcfg, params_from_numpy(np_params, device="cpu"),
        params_from_numpy(np_dparams, device="cpu"), torch.from_numpy(tok), tc, td,
        torch.from_numpy(rem), k=3, gamma=2, max_seq=MAX_SEQ, compute_dtype=torch.float32)
    # tokens, remaining, out_tokens, n_out, accepted, proposed, bad
    for t, j in zip((tout[0], tout[3], *tout[4:]), (jout[0], jout[3], *jout[5:])):
        assert t.tolist() == np.asarray(j).tolist()
    assert tout[7].sum() > tout[6].sum()  # drafts rejected: rollback ran
    for t, j in ((tout[1], jout[1]), (tout[2], jout[2])):
        assert t["index"].tolist() == np.asarray(j["index"]).tolist()
        _tree_close(t["layers"], j["layers"], "layers")
    # rolled back in place, in the cache's own tensors; the frozen slot kept
    new = tree_leaves(T.chunk_recurrent_states(cfg, tout[1]["layers"]))
    assert all(a is b for a, b in zip(new, live))
    for t, f in zip(new, frozen):
        got = t[:, 2] if T.recurrent_state_batch_axis(cfg) == 1 else t[:, :, 2]
        assert torch.equal(got, f)
