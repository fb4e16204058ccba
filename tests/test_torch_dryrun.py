"""The port's analysis layer against the reference's, on the CPU.

``repro_torch.launch.cells`` / ``cost`` / ``roofline`` / ``dryrun`` are the
counterparts of ``repro.launch.cells`` / ``hlo_cost`` / ``hlo`` /
``dryrun``.  The reference compiles each cell and walks the HLO; the port
counts one step of one rank as it runs on ``meta`` tensors.

* (a) The shape matrix (``configs.all_cells`` with the skipped cells and
  their reasons, ``get_shape``, ``shape_applicable``), ``TRAIN_MICROBATCHES``,
  ``train_config_for`` and ``model_flops`` for every (arch, shape) equal the
  reference's.
* (b) The collectives' ring-model pricing equals ``hlo_cost.analyze`` on a
  hand-written HLO module with one of each collective at group sizes 1, 2
  and 16; ``roofline_terms(..., hw=V5E)`` equals ``hlo.roofline_terms``
  field for field.
* (c) The product FLOPs (the ops ``torch.utils.flop_counter`` prices) of
  the qwen3 smoke's ``lm_loss`` value-and-grad, ``prefill`` and
  ``decode_step`` with the plain attention (``impl="torch"``) equal the
  reference's HLO ``dot`` / ``convolution`` FLOPs exactly (its
  ``HloCostModel`` restricted to them); with the kernels counted the
  products fall by the plain attention's QK^T and PV, computed here.
* (d) On a (2, 1) mesh without FSDP rank 0's product FLOPs x 2 equal the
  unsharded step's, dense and MoE; on (1, 2) too, but for the MoE router's
  products, which every model rank computes whole.
* (e) The argument bytes of a (2, 2) train cell are the sum of its state
  and batch shards' bytes under the step's spec trees.
* (f) Every arch's train / prefill / decode smoke cell counts on a (2, 2)
  recording mesh, its path's kernels among the launches.
* (g) ``run_cell`` writes every field for qwen3-1.7b ``decode_32k`` and
  falcon-mamba-7b ``prefill_32k`` at full size on the 16x16 mesh, in
  seconds (the plain scan, stepping through 32,768 positions in Python,
  would not finish), and the reference's reason for a skipped cell.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import flop_registry

from repro import configs as jconfigs
from repro.core import hardware as jhw
from repro.launch import cells as jcells
from repro.launch import hlo as jhlo
from repro.launch import hlo_cost as jhc
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.hardware import V5E
from repro_torch.launch import cells, cost, dryrun
from repro_torch.launch.roofline import roofline_terms
from repro_torch.models import transformer as T
from repro_torch.runtime import sharding as S
from repro_torch.runtime import step as ST
from repro_torch.tree import tree_leaves, tree_map

#: the aten ops whose FLOPs ``torch.utils.flop_counter`` prices: the products
PRODUCTS = {str(k) for k in flop_registry}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _products(counted: dict) -> float:
    return sum(v["flops"] for k, v in counted["ops"].items() if k in PRODUCTS)


class _DotCost(jhc.HloCostModel):
    """The reference's cost model restricted to ``dot`` / ``convolution``."""

    def _instr_flops(self, comp, ins):
        if ins.opcode in ("dot", "convolution"):
            return super()._instr_flops(comp, ins)
        return 0.0, 0.0


# ---------------------------------------------------------------------------
# (a) the shape matrix and the cells' settings
# ---------------------------------------------------------------------------


def test_shape_matrix_equals_the_reference():
    assert list(configs.all_cells(include_skipped=True)) == list(
        jconfigs.all_cells(include_skipped=True))
    assert list(configs.all_cells()) == list(jconfigs.all_cells())
    assert len(list(configs.all_cells(include_skipped=True))) == 40
    for name in configs.SHAPES:
        assert dataclasses.asdict(configs.get_shape(name)) == dataclasses.asdict(
            jconfigs.get_shape(name))
    with pytest.raises(KeyError):
        configs.get_shape("train_8k")
    for arch in configs.ARCH_IDS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        assert (cfg.attention_free, cfg.sub_quadratic) == (jcfg.attention_free,
                                                           jcfg.sub_quadratic)
        for name in configs.SHAPES:
            assert configs.shape_applicable(cfg, configs.get_shape(name)) == \
                jconfigs.shape_applicable(jcfg, jconfigs.get_shape(name))


def test_cell_settings_equal_the_reference():
    assert cells.TRAIN_MICROBATCHES == jcells.TRAIN_MICROBATCHES
    for arch in configs.ARCH_IDS:
        assert dataclasses.asdict(cells.train_config_for(arch)) == dataclasses.asdict(
            jcells.train_config_for(arch))
        assert dataclasses.asdict(cells.train_config_for(arch, layout="dp256")) == \
            dataclasses.asdict(jcells.train_config_for(arch, layout="dp256"))
        for name in configs.SHAPES:
            assert cells.model_flops(configs.get_config(arch), configs.get_shape(name)) == \
                jcells.model_flops(jconfigs.get_config(arch), jconfigs.get_shape(name))


# ---------------------------------------------------------------------------
# (b) collectives and the roofline
# ---------------------------------------------------------------------------

#: group size -> the HLO's replica_groups for it
GROUPS = {1: "replica_groups={{0}}", 2: "replica_groups={{0,1}}",
          16: "replica_groups=[1,16]<=[16]"}
N = 4096  # f32 elements of a collective's whole tensor


def _hlo_module() -> str:
    lines = []
    for g, groups in GROUPS.items():
        lines += [
            f"  %ar{g} = f32[{N}]{{0}} all-reduce(f32[{N}]{{0}} %p), {groups}, to_apply=%add",
            f"  %ag{g} = f32[{N}]{{0}} all-gather(f32[{N // g}]{{0}} %s{g}), {groups}, "
            "dimensions={0}",
            f"  %rs{g} = f32[{N // g}]{{0}} reduce-scatter(f32[{N}]{{0}} %p), {groups}, "
            "dimensions={0}, to_apply=%add",
            f"  %aa{g} = f32[{N}]{{0}} all-to-all(f32[{N}]{{0}} %p), {groups}, dimensions={{0}}",
        ]
    slices = [f"  %s{g} = f32[{N // g}]{{0}} slice(f32[{N}]{{0}} %p), slice={{[0:{N // g}]}}"
              for g in GROUPS]
    return "\n".join([
        "HloModule collectives", "",
        "%add (a: f32[], b: f32[]) -> f32[] {",
        "  %a = f32[] parameter(0)",
        "  %b = f32[] parameter(1)",
        "  ROOT %sum = f32[] add(f32[] %a, f32[] %b)",
        "}", "",
        f"ENTRY %main (p: f32[{N}]) -> f32[{N}] {{",
        f"  %p = f32[{N}]{{0}} parameter(0)",
        *slices, *lines,
        f"  ROOT %out = f32[{N}]{{0}} add(f32[{N}]{{0}} %ar1, f32[{N}]{{0}} %ar2)",
        "}", ""])


def _port_collectives() -> dict:
    """The same collectives through the recording mesh (all-to-all, which
    the mesh never makes, through the counting mode)."""

    def run():
        mode = cost._active()
        for g in GROUPS:
            mesh = cost.RecordingMesh((g,), ("data",))
            mesh.all_reduce(torch.empty(N, device="meta"), ("data",))
            mesh.all_gather(torch.empty(N // g, device="meta"), ("data",), 0)
            mesh.reduce_scatter(torch.empty(N, device="meta"), ("data",), 0)
            mode.collective("all-to-all", 4.0 * N, g)

    return cost.analyze(run)


def test_collective_pricing_equals_the_reference():
    ref = jhc.analyze(_hlo_module())
    got = _port_collectives()
    assert set(got["collectives"]) == set(ref["collectives"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all"}
    for kind, want in ref["collectives"].items():
        assert got["collectives"][kind] == pytest.approx(want, rel=1e-12), kind
    for key in ("collective_result_bytes", "collective_wire_bytes"):
        assert got[key] == pytest.approx(ref[key], rel=1e-12)


def test_roofline_on_v5e_equals_the_reference():
    parsed = dict(jhc.analyze(_hlo_module()), flops=3.2e12, bytes_accessed=7.5e11)
    for n_devices, model_flops in ((256, 6.1e14), (512, 1.0)):
        want = jhlo.roofline_terms(parsed=parsed, n_devices=n_devices,
                                   model_flops=model_flops).as_dict()
        got = roofline_terms(parsed=parsed, n_devices=n_devices, model_flops=model_flops,
                             hw=V5E).as_dict()
        assert got == want
    assert (V5E.peak_flops, V5E.hbm_bandwidth, V5E.link_bandwidth) == (
        jhw.V5E.peak_flops, jhw.V5E.hbm_bandwidth, jhw.V5E.link_bandwidth) == (
        jhlo.PEAK_FLOPS, jhlo.HBM_BW, jhlo.LINK_BW)


# ---------------------------------------------------------------------------
# (c) product FLOPs against the reference's HLO dots
# ---------------------------------------------------------------------------

ARCH, B, SEQ, CACHE = "qwen3-1.7b", 2, 32, 64


@pytest.fixture(scope="module")
def qwen3():
    jcfg, cfg = jconfigs.smoke_config(ARCH), configs.smoke_config(ARCH)
    return jcfg, cfg, JT.init_params(jcfg, jax.random.PRNGKey(0))


def _meta_int(*shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _attention_pairs(cfg, queries: int, keys: int) -> float:
    """QK^T and PV of the plain attention over every (query, key) pair (its
    mask is applied after the product): 2 products of 2 FLOPs a pair and
    head dim, every head and layer."""
    return 4.0 * queries * keys * cfg.num_heads * cfg.resolved_head_dim * cfg.num_layers


def test_loss_grad_products_equal_the_reference(qwen3):
    jcfg, cfg, jparams = qwen3
    toks = jnp.zeros((B, SEQ), jnp.int32)
    hlo = jax.jit(jax.value_and_grad(lambda p, i, l: JT.lm_loss(jcfg, p, i, l)[0])).lower(
        jparams, toks, toks).compile().as_text()
    ref = _DotCost(hlo).total().flops
    params = tree_map(lambda p: p.requires_grad_(True), ST.abstract_params(cfg))

    def value_and_grad(impl):
        def run(params, inputs, labels):
            loss, _ = T.lm_loss(cfg, params, inputs, labels, impl=impl)
            return loss, torch.autograd.grad(loss, tree_leaves(params))
        return run

    plain = cost.analyze(value_and_grad("torch"), params, _meta_int(B, SEQ),
                         _meta_int(B, SEQ), impl="torch", table=True)
    kernels = cost.analyze(value_and_grad("auto"), params, _meta_int(B, SEQ),
                           _meta_int(B, SEQ), table=True)
    assert _products(plain) == ref == 37_748_736
    # forward QK^T and PV, and the backward's two products for each
    assert _products(plain) - _products(kernels) == 3 * _attention_pairs(cfg, B * SEQ, SEQ)
    assert kernels["kernels"] == {"flash_fwd_tc_kernel": cfg.num_layers,
                                  "flash_bwd_delta_kernel": cfg.num_layers,
                                  "flash_bwd_dkdv_tc_kernel": cfg.num_layers,
                                  "flash_bwd_dq_tc_kernel": cfg.num_layers}


def test_prefill_and_decode_products_equal_the_reference(qwen3):
    jcfg, cfg, jparams = qwen3
    toks = jnp.zeros((B, SEQ), jnp.int32)
    ref_prefill = _DotCost(jax.jit(lambda p, i: JT.prefill(jcfg, p, i, CACHE)).lower(
        jparams, toks).compile().as_text()).total().flops
    jcache = JT.init_cache(jcfg, B, CACHE, jnp.bfloat16)
    ref_decode = _DotCost(jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, t, c)).lower(
        jparams, jnp.zeros((B,), jnp.int32), jcache).compile().as_text()).total().flops
    params = ST.abstract_params(cfg)
    got = {}
    for impl in ("torch", "auto"):
        pre = cost.analyze(lambda p, i: T.prefill(cfg, p, i, CACHE, impl=impl), params,
                           _meta_int(B, SEQ), impl=impl, table=True)
        dec = cost.analyze(lambda p, t, c: T.decode_step(cfg, p, t, c, attn_impl=impl), params,
                           _meta_int(B), ST.abstract_cache(cfg, B, CACHE), impl=impl,
                           table=True)
        got[impl] = (_products(pre), _products(dec))
    assert got["torch"] == (ref_prefill, ref_decode)
    # the decode's plain attention reads the whole cache, masked
    assert got["torch"][0] - got["auto"][0] == _attention_pairs(cfg, B * SEQ, SEQ)
    assert got["torch"][1] - got["auto"][1] == _attention_pairs(cfg, B, CACHE)


# ---------------------------------------------------------------------------
# (d) - (f) cells on recording meshes
# ---------------------------------------------------------------------------

TRAIN = ShapeConfig("smoke_train", 16, 4, "train")


def _unsharded(cfg, tcfg) -> dict:
    state = ST.abstract_train_state(cfg, tcfg)
    tree_map(lambda p: p.requires_grad_(True), state["params"])
    return cost.analyze(ST.make_train_step(cfg, tcfg, device="meta"), state,
                        ST.abstract_batch(cfg, TRAIN), table=True)


def _train_cell(arch, cfg, tcfg, mesh) -> cells.Cell:
    return cells.Cell(arch, TRAIN, cfg, "train", ST.ShardedTrainStep(cfg, tcfg, mesh,
                                                                    device="meta"))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "moonshot-v1-16b-a3b"])
def test_rank_products_times_ranks_equal_the_unsharded_step(arch):
    cfg = configs.smoke_config(arch)
    tcfg = cells.train_config_for(arch, microbatches=1, fsdp=False, zero1=False)
    whole = _products(_unsharded(cfg, tcfg))
    data = _train_cell(arch, cfg, tcfg, cost.RecordingMesh((2, 1), ("data", "model")))
    assert 2 * _products(data.count(table=True)) == whole
    model = _train_cell(arch, cfg, tcfg, cost.RecordingMesh((1, 2), ("data", "model")))
    # the router's products ([tokens, d] x [d, E]: twice forward under remat
    # "full", its input's and its weight's gradients) run whole on each rank
    tokens = TRAIN.global_batch * TRAIN.seq_len
    router = 4 * 2.0 * tokens * cfg.d_model * cfg.num_experts * cfg.num_layers
    assert 2 * _products(model.count(table=True)) == whole + (router if cfg.num_experts else 0)


def test_argument_bytes_are_the_shards():
    arch = "qwen3-1.7b"
    cfg = configs.smoke_config(arch)
    mesh = cost.RecordingMesh((2, 2), ("data", "model"))
    tcfg = cells.train_config_for(arch, microbatches=2)
    cell = _train_cell(arch, cfg, tcfg, mesh)
    step = cell.artifacts

    def shard_bytes(t, spec):
        split = math.prod(mesh.size(axes) for _, axes in S._sharded_dims(spec, mesh))
        return t.numel() // split * t.element_size()

    full = ST.abstract_train_state(cfg, tcfg)
    want = sum(tree_leaves(tree_map(shard_bytes, full, {k: step.state_specs[k] for k in full})))
    want += sum(tree_leaves(tree_map(shard_bytes, ST.abstract_batch(cfg, TRAIN),
                                     step.batch_specs)))
    counted = cell.count()
    assert counted["memory"]["argument_size_in_bytes"] == want
    assert counted["memory"]["peak_bytes_per_device"] > want
    # FSDP split the big leaves over data: fewer bytes than the whole tree
    assert want < sum(t.numel() * t.element_size() for t in tree_leaves(full))


def _path_kernels(cfg, kind) -> set:
    if kind == "train":
        return ({"ssm_scan_kernel", "ssm_scan_bwd_kernel", "sum_partials_kernel"}
                if cfg.family == "ssm" else {"flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel"})
    if kind == "prefill":
        return {"ssm_scan_kernel"} if cfg.family == "ssm" else {"flash_fwd_tc_kernel"}
    # a Mamba1 decode step runs no kernel of ours
    return set() if cfg.family == "ssm" else {"dense_decode_cluster_kernel"}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_smoke_cell_counts_on_a_2x2_mesh(arch):
    cfg = configs.smoke_config(arch)
    mesh = cost.RecordingMesh((2, 2), ("data", "model"))
    built = {
        "train": _train_cell(arch, cfg, cells.train_config_for(arch, microbatches=2), mesh),
        "prefill": cells.Cell(arch, TRAIN, cfg, "prefill", ST.make_prefill_step(
            cfg, mesh, ShapeConfig("smoke_prefill", 32, 4, "prefill"))),
        "decode": cells.Cell(arch, TRAIN, cfg, "decode", ST.make_serve_step(
            cfg, mesh, ShapeConfig("smoke_decode", 64, 4, "decode"))),
    }
    for kind, cell in built.items():
        counted = cell.count()
        mem = counted["memory"]
        assert counted["flops"] > 0 and counted["bytes_accessed"] > 0, kind
        assert _path_kernels(cfg, kind) <= set(counted["kernels"]), (kind, counted["kernels"])
        assert counted["launches"] >= sum(counted["kernels"].values()), kind
        assert counted["collectives"]["all-reduce"]["group_sizes"], kind
        assert mem["peak_bytes_per_device"] >= mem["argument_size_in_bytes"] > 0, kind


# ---------------------------------------------------------------------------
# (g) run_cell at full size
# ---------------------------------------------------------------------------

RECORD_KEYS = {"arch", "shape", "mesh", "kind", "n_devices", "build_s", "count_s", "memory",
               "cost", "roofline", "hbm_ok", "hardware", "train_overrides", "options"}


@pytest.mark.parametrize("arch, shape, kernels", [
    # qwen3's 8 KV heads do not split 16 ways: the decode splits the cache's
    # sequence over model, #3's partial form and the merge once a layer
    ("qwen3-1.7b", "decode_32k", ("dense_decode_partial_kernel", "combine_splits")),
    ("falcon-mamba-7b", "prefill_32k", ("ssm_scan_kernel",)),
])
def test_run_cell_writes_every_field(tmp_path, arch, shape, kernels):
    record = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=str(tmp_path))
    on_disk = json.loads((tmp_path / "pod_16x16" / f"{arch}__{shape}.json").read_text())
    assert on_disk == json.loads(json.dumps(record))
    assert set(record) == RECORD_KEYS
    assert record["n_devices"] == 256 and record["kind"] == configs.get_shape(shape).kind
    assert record["count_s"] < 60  # the plain scan would step 32,768 positions in Python
    cfg = configs.get_config(arch)
    assert {k: record["cost"]["kernels"][k] for k in kernels} == dict.fromkeys(
        kernels, cfg.num_layers)
    assert set(record["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                     "alias_size_in_bytes", "temp_size_in_bytes",
                                     "peak_bytes_per_device"}
    roof = record["roofline"]
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"], roof["collective_s"]) > 0
    assert roof["model_flops"] == cells.model_flops(cfg, configs.get_shape(shape))
    assert record["hbm_ok"] == (record["memory"]["peak_bytes_per_device"] <= 80 * 10**9)


def test_run_cell_records_a_skipped_cell(tmp_path):
    record = dryrun.run_cell("qwen3-1.7b", "long_500k", multi_pod=True, out_dir=str(tmp_path))
    want = jconfigs.shape_applicable(jconfigs.get_config("qwen3-1.7b"),
                                     jconfigs.get_shape("long_500k"))[1]
    assert record == {"arch": "qwen3-1.7b", "shape": "long_500k", "mesh": "multipod_2x16x16",
                      "kind": "decode", "skipped": want}
    assert json.loads((tmp_path / "multipod_2x16x16" / "qwen3-1.7b__long_500k.json")
                      .read_text()) == record
