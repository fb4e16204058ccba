"""The train step the card replays as one CUDA graph
(``TrainStepArtifacts.jitted``), on the CPU, and the bookkeeping of
``serving.graphs.AddressedGraphs`` that keeps a graph from pinning what it
was captured with.

(a) ``make_train_step``'s step, for the qwen3-1.7b, moonshot-v1-16b-a3b,
falcon-mamba-7b, zamba2-2.7b and musicgen-large smokes under remat
``"none"``, ``"full"`` and ``"dots"`` and under ``int8_ef`` with two
microbatches, and ``ShardedTrainStep`` on a one-rank gloo mesh (FSDP,
ZeRO-1, ``int8_ef``, two microbatches), run under
``tests/test_torch_graphs.py``'s ``HostSyncs``: no host sync, no
data-dependent shape, no host data turned into a tensor (the kernel entry
points not recorded: the card runs the kernel there).

(b) ``TrainStepArtifacts`` against the reference's: the state, batch and
metric spec trees equal, as tuples, the reference's ``param_specs`` /
``opt_state_specs`` / ``batch_specs`` composition (its
``make_train_step``'s) on the same mesh shapes, without a mesh (the
reference's one-device ``make_dev_mesh()``) and on 2- and 4-rank stand-ins
(``launch.cost.RecordingMesh`` for the port, a shape-only mesh for the
reference), FSDP, ZeRO-1 and ``int8_ef`` on; ``abstract_state()`` /
``abstract_batch(shape)`` shapes and dtypes equal the reference's
``abstract_train_state`` / ``abstract_batch`` (full-size configs, nothing
allocated).  On the CPU ``jitted()`` is the eager step (bit-equal over 3
steps); ``jitted(donate=False)`` raises ``NotImplementedError``; AdamW
keeps ``opt["step"]`` as the caller's tensor and stays bit-equal to the
reference's update.

(c) ``AddressedGraphs`` with a stand-in for ``GraphProgram`` and the pool
handle (a "replay" runs the captured function again): a graph is dropped
once the tensors it was keyed by are collected; a cache of known shapes at
new addresses adds no graph and is copied into the graph's buffers; the
returned cache is the graph's buffers, which the next call passes back; a
state's first call under ``warm_by_call`` is its eager warm-up, and a state
at new addresses captures anew while the old graph goes with the old
state.
"""
import contextlib
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.optim import adamw_update as jadamw_update
from repro.runtime import sharding as JS
from repro.runtime.step import abstract_batch as jabstract_batch
from repro.runtime.step import abstract_train_state as jabstract_train_state
from repro_torch import configs
from repro_torch.configs import TrainConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticDataset
from repro_torch.kernels import ops
from repro_torch.launch.cost import RecordingMesh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.runtime import TrainStepArtifacts, init_train_state, make_train_step
from repro_torch.serving import graphs as G
from repro_torch.tree import tree_leaves, tree_map
from test_torch_graphs import _ENTRY_POINTS, HostSyncs

SEQ, BATCH = 16, 4


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


def _batch(cfg, seed=0):
    """A batch as the jitted step hands it to its graph: tensors on the
    step's device."""
    ds = SyntheticDataset(cfg=cfg, seq_len=SEQ, global_batch=BATCH, seed=seed)
    return {k: torch.as_tensor(v) for k, v in ds.next_batch().items()}


def _state(cfg, tcfg, seed=0):
    return init_train_state(T.init_params(cfg, torch.Generator().manual_seed(seed)), tcfg)


# ---------------------------------------------------------------------------
# (a) the train step never syncs the host
# ---------------------------------------------------------------------------

ARCHS = ("qwen3-1.7b", "moonshot-v1-16b-a3b", "falcon-mamba-7b", "zamba2-2.7b",
         "musicgen-large")
STEP_CASES = {
    "none": {},
    "full": {"remat_policy": "full"},
    "dots": {"remat_policy": "dots"},
    "int8_ef-micro2": {"grad_compression": "int8_ef", "microbatches": 2},
}


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_never_syncs_the_host(arch, case, monkeypatch):
    cfg = configs.smoke_config(arch)
    tcfg = TrainConfig(**STEP_CASES[case])
    step = make_train_step(cfg, tcfg, device="cpu").jitted()
    state, batch = _state(cfg, tcfg), _batch(cfg)
    with _recording(monkeypatch) as mode:
        _, metrics = step(state, batch)
    assert mode.events == []
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("kw", [{}, {"grad_compression": "int8_ef", "microbatches": 2}],
                         ids=["fsdp-zero1", "fsdp-zero1-int8_ef-micro2"])
def test_sharded_train_step_never_syncs_the_host(kw, one_rank_mesh, monkeypatch):
    cfg = configs.smoke_config("qwen3-1.7b")
    tcfg = TrainConfig(fsdp=True, zero1=True, **kw)
    art = make_train_step(cfg, tcfg, one_rank_mesh, device="cpu")
    state = art.init_state(T.init_params(cfg, torch.Generator().manual_seed(0)))
    batch = art.shard_batch(_batch(cfg))
    with _recording(monkeypatch) as mode:
        art.jitted()(state, batch)
    assert mode.events == []
    assert art.last_collectives.get("all_reduce", 0) > 0


# ---------------------------------------------------------------------------
# (b) TrainStepArtifacts against the reference's
# ---------------------------------------------------------------------------


class FakeMesh:
    """Shape / axis-name stand-in (the reference's rules read only these)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


#: (data, model): none (the reference's ``make_dev_mesh()``), 2 and 4 ranks
MESH_SHAPES = {"none": None, "2x1": (2, 1), "2x2": (2, 2), "4x1": (4, 1)}
SPEC_ARCHS = ("qwen3-1.7b", "moonshot-v1-16b-a3b", "zamba2-2.7b", "musicgen-large")
SPEC_TCFG = dict(fsdp=True, zero1=True, grad_compression="int8_ef")


def _flat_ref(tree, is_leaf=None) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in leaves}


def _flat_port(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _ref_specs(arch, mesh_shape, layout):
    """The reference's ``make_train_step`` spec trees on a mesh of
    ``mesh_shape`` (its ``make_dev_mesh()`` when None)."""
    jcfg = jconfigs.get_config(arch)
    jtcfg = JTrainConfig(layout=layout, **SPEC_TCFG)
    data, model = mesh_shape or (1, 1)
    mesh = FakeMesh({"data": data, "model": model})
    params = jabstract_train_state(jcfg, jtcfg)["params"]
    param_sp = JS.param_specs(jcfg, params, mesh=mesh, fsdp=jtcfg.fsdp, layout=layout)
    state = {"params": param_sp,
             "opt": JS.opt_state_specs(jcfg, params, jtcfg.zero1, mesh, fsdp=jtcfg.fsdp,
                                       layout=layout),
             "err": param_sp}
    metrics = {k: jax.sharding.PartitionSpec()
               for k in ("loss", "ce", "moe_aux", "grad_norm", "lr")}
    return state, JS.batch_specs(jcfg, None, mesh, layout=layout), metrics


@pytest.mark.parametrize("layout", ["tp", "dp256"])
@pytest.mark.parametrize("mesh", list(MESH_SHAPES))
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_spec_trees_match_reference(arch, mesh, layout):
    cfg, shape = configs.get_config(arch), MESH_SHAPES[mesh]
    tcfg = TrainConfig(layout=layout, **SPEC_TCFG)
    stand_in = None if shape is None else RecordingMesh(shape, ("data", "model"))
    art = make_train_step(cfg, tcfg, stand_in, device="meta")
    assert isinstance(art, TrainStepArtifacts) and art.mesh is stand_in
    ref = _ref_specs(arch, shape, layout)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    for got, want in zip((art.state_specs, art.batch_specs, art.metric_specs), ref):
        got = {k: tuple(v) for k, v in _flat_port(got).items()}
        assert got == {k: tuple(v) for k, v in _flat_ref(want, is_spec).items()}


def _port_shapes(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in _flat_port(tree).items()}


def _ref_shapes(tree) -> dict:
    return {k: (tuple(v.shape), jnp.dtype(v.dtype).name) for k, v in _flat_ref(tree).items()}


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "falcon-mamba-7b", "zamba2-2.7b",
                                  "musicgen-large"])
def test_abstract_trees_match_reference(arch, compression):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    art = make_train_step(cfg, TrainConfig(grad_compression=compression), device="meta")
    jtcfg = JTrainConfig(grad_compression=compression)
    assert _port_shapes(art.abstract_state()) == _ref_shapes(
        jabstract_train_state(jcfg, jtcfg))
    shape = jconfigs.get_shape("train_4k")
    port_batch = art.abstract_batch(ShapeConfig(shape.name, shape.seq_len, shape.global_batch,
                                                shape.kind))
    assert _port_shapes(port_batch) == _ref_shapes(jabstract_batch(jcfg, shape))
    assert all(t.device.type == "meta" for t in tree_leaves(art.abstract_state()))


def test_jitted_on_the_cpu_is_the_eager_step():
    cfg = configs.smoke_config("qwen3-1.7b")
    tcfg = TrainConfig(warmup_steps=1, total_steps=4)
    art = make_train_step(cfg, tcfg, device="cpu")
    jitted = art.jitted()
    assert jitted is art
    eager, replayed = _state(cfg, tcfg), _state(cfg, tcfg)
    for i in range(3):
        batch = _batch(cfg, seed=i)
        _, m_eager = art(eager, batch)
        out, m_jit = jitted(replayed, batch)
        assert out is replayed
        assert all(torch.equal(m_eager[k], m_jit[k]) for k in m_eager)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(eager), tree_leaves(replayed)))
    with pytest.raises(NotImplementedError, match="donate=False"):
        art.jitted(donate=False)


def _jax(t):
    """A JAX copy of ``t`` (a CPU array may alias numpy's memory, which the
    port's in-place update then writes)."""
    return jnp.array(t.numpy(), copy=True)


def test_adamw_keeps_the_step_counter_and_matches_reference():
    rng = np.random.default_rng(0)
    draw = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    params = {"a": draw(4, 6), "b": {"c": draw(5), "d": draw(3, 2, 2)}}
    opt = adamw_init(params)
    counter = opt["step"]
    tcfg = JTrainConfig()
    jparams = tree_map(lambda t: _jax(t), params)
    jopt = {"mu": tree_map(lambda t: _jax(t), opt["mu"]),
            "nu": tree_map(lambda t: _jax(t), opt["nu"]),
            "step": jnp.asarray(0, jnp.int32)}
    for i in range(3):
        grads = tree_map(lambda p: torch.from_numpy(
            rng.normal(size=tuple(p.shape)).astype(np.float32)), params)
        jgrads = tree_map(lambda t: _jax(t), grads)
        adamw_update(grads, opt, params, lr=1e-2, cfg=tcfg)
        jparams, jopt = jadamw_update(jgrads, jopt, jparams, lr=1e-2, cfg=tcfg)
        assert opt["step"] is counter and int(counter) == int(jopt["step"]) == i + 1
        for got, want in ((params, jparams), (opt["mu"], jopt["mu"]), (opt["nu"], jopt["nu"])):
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                assert np.array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# (c) AddressedGraphs' bookkeeping
# ---------------------------------------------------------------------------


class _FakeProgram:
    """``GraphProgram``'s interface without a card: the "capture" runs
    ``fn`` once, a "replay" runs it again on the refilled static inputs and
    writes its non-held outputs where the capture's lie."""

    def __init__(self, fn, inputs, *, pool, side, warm=None, generator=None):
        self.fn = fn
        self.static = {k: v.clone() for k, v in inputs.items()}
        if warm is not None:
            warm({k: v.clone() for k, v in self.static.items()})
        self.out = fn(self.static)
        self.launches, self.bodies, self.capture_s = {}, {}, 0.0

    def replay(self, inputs):
        for k, v in inputs.items():
            self.static[k].copy_(v)
        for mine, fresh in zip(self.out, self.fn(self.static)):
            if mine is not None:
                mine.copy_(fresh)
        return self.out


class _Stream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(G, "GraphProgram", _FakeProgram)
    monkeypatch.setattr(G, "_CAPTURE_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())


def _decode(held, inp):
    """A decode-like program: reads the weights and the cache's ``h``,
    writes the cache's ``g`` in place (the same value at every run, so a
    stand-in capture that runs it changes nothing)."""
    w, cache = held
    cache["g"].copy_(w * inp["x"])
    return (cache["h"] * w).sum() + inp["x"].sum(), cache


def _cache(value):
    return {"h": torch.full((3,), float(value)), "g": torch.zeros(3)}


def test_graph_dropped_when_its_tensors_are_collected(fake_card):
    graphs = G.AddressedGraphs(_decode, cache=True)
    w, x = torch.full((3,), 2.0), {"x": torch.ones(3)}
    out, cache = graphs((w, _cache(1)), x)
    assert float(out) == 9.0 and graphs.captures == 1 and len(graphs.graphs) == 1
    dead = weakref.ref(w)
    del w
    gc.collect()
    assert dead() is None and graphs.graphs == {}
    # the cache buffers went with the graph (the caller's returned dict aside)
    buffers = [weakref.ref(t) for t in cache.values()]
    del cache, out
    gc.collect()
    assert all(b() is None for b in buffers)
    # a program keyed by address alone (a prefill, a train state)
    keyed = G.AddressedGraphs(lambda held, inp: held["p"] * inp["x"])
    held = {"p": torch.arange(3.0)}
    assert torch.equal(keyed(held, x), torch.arange(3.0))
    dead = weakref.ref(held["p"])
    del held
    gc.collect()
    assert dead() is None and keyed.graphs == {} and keyed.captures == 1


def test_new_cache_of_known_shapes_is_copied_in_and_returned(fake_card):
    graphs = G.AddressedGraphs(_decode, cache=True,
                               kept=lambda held: [held[1]["g"]])
    w, x = torch.full((3,), 2.0), {"x": torch.ones(3)}
    first = _cache(1)
    out, returned = graphs((w, first), x)
    graph, = graphs.graphs.values()
    assert float(out) == 9.0
    # the first call's cache became the graph's buffers and is returned
    assert [returned[k] for k in ("h", "g")] == graph.cache
    assert returned["h"] is first["h"] and torch.equal(returned["g"], torch.full((3,), 2.0))
    # a fresh cache of the same shapes: copied in, no new graph
    for value in (3, 5):
        fresh = _cache(value)
        out, back = graphs((w, fresh), {"x": torch.full((3,), 2.0)})
        assert graphs.captures == 1 and len(graphs.graphs) == 1
        assert float(out) == 6.0 * value + 6.0
        assert back["h"] is graph.cache[0] and back["g"] is graph.cache[1]
        assert torch.equal(back["h"], fresh["h"]) and torch.equal(back["g"], 4.0 * torch.ones(3))
    # passing back what was returned reads the graph's own buffers
    back["h"].fill_(7.0)
    out, again = graphs((w, back), x)
    assert float(out) == 45.0 and again["h"] is back["h"] and graphs.captures == 1
    # new shapes: a second graph
    graphs((w, {"h": torch.ones(2, 3), "g": torch.zeros(3)}), x)
    assert graphs.captures == 2 and len(graphs.graphs) == 2


def test_warm_by_call_returns_the_eager_call_and_follows_the_state(fake_card):
    calls = []

    def step(state, batch):
        calls.append(1)
        return {"loss": (state["w"] * batch["x"]).sum()}

    graphs = G.AddressedGraphs(step, warm_by_call=True)
    batch = {"x": torch.ones(2)}
    state = {"w": torch.tensor([1.0, 2.0])}
    first = graphs(state, batch)
    # the warm-up call, then the stand-in capture's run
    assert float(first["loss"]) == 3.0 and len(calls) == 2 and graphs.captures == 1
    state["w"].mul_(2.0)
    assert float(graphs(state, batch)["loss"]) == 6.0 and graphs.captures == 1
    # a state at new addresses (a remesh): captured anew, the old graph
    # dropped once the old tensors die
    old = weakref.ref(state["w"])
    state["w"] = state["w"].clone()
    gc.collect()
    assert old() is None and graphs.graphs == {}
    assert float(graphs(state, batch)["loss"]) == 6.0 and graphs.captures == 2
    assert len(graphs.graphs) == 1
