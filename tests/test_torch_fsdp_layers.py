"""FSDP weights gathered one layer at a time (``models.fsdp``), on the CPU
over gloo.

The sharded train step's gradients against the whole-tree gather the step
ran before (``_whole_tree_grads``, below: every FSDP-split leaf
all-gathered before the forward, its gradient reduce-scattered after the
microbatches), on the same state and rows: bit-equal over 2 ranks, within
``RTOL`` of a leaf's max over 4 (gloo's sum over 4 ranks depends on the
buffer it reduces), for the dense, MoE and hybrid smokes under remat
``"none"``, ``"dots"`` and ``"full"``, FSDP + ZeRO-1, with and without
microbatches.  Each case holds the most gathered bytes alive at once
(``max_live_gathered_bytes``) to one layer's gathered weights plus every
split leaf outside the stacks, and below the whole tree's.  Then the serve
steps with FSDP weights (prefill + decode) give the tokens and logits of
the same steps without FSDP, bit for bit, under the same bound.

One spawn of 4 ranks, which then runs the 2-rank cases on two of them over
a second group (each rank one torch thread, a ``FileStore`` in
``tmp_path``, FSDP's size floor lowered to 1024 so the smoke leaves shard).
"""
from __future__ import annotations

import os
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.configs import TrainConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticDataset
from repro_torch.models import transformer as T
from repro_torch.runtime import make_train_step
from repro_torch.runtime import step as step_mod
from repro_torch.tree import tree_leaves, tree_unflatten

RTOL = 1e-5
SEQ, BATCH = 16, 8
SPAWN_TIMEOUT_S = 150
FSDP_MIN = 1024
QWEN, MOE, HYBRID = "qwen3-1.7b", "moonshot-v1-16b-a3b", "zamba2-2.7b"
#: (case name, arch, remat policy, microbatches, mesh shape) by world size;
#: the mesh is (data, model)
TRAIN_CASES = {
    2: [(f"dense_{r}_m{m}", QWEN, r, m, (2, 1)) for r in ("none", "dots", "full")
        for m in (1, 2)]
    + [("moe_none_m2", MOE, "none", 2, (2, 1)), ("moe_full_m1", MOE, "full", 1, (2, 1)),
       ("hybrid_none_m1", HYBRID, "none", 1, (2, 1)),
       ("hybrid_full_m2", HYBRID, "full", 2, (2, 1))],
    4: [(f"dense_{r}_d4", QWEN, r, 1, (4, 1)) for r in ("none", "dots", "full")]
    + [("dense_dots_m2_d4", QWEN, "dots", 2, (4, 1)), ("moe_full_m2_d4", MOE, "full", 2, (4, 1)),
       ("dense_tp_2x2", QWEN, "none", 1, (2, 2))],
}
#: serve cases: (name, arch, mesh shape) by world size
SERVE_CASES = {2: [("serve_dense_d2", QWEN, (2, 1)), ("serve_moe_d2", MOE, (2, 1))],
               4: [("serve_dense_d4", QWEN, (4, 1))]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _whole_tree_grads(step, state, batch):
    """The step's gradients as the whole-tree gather computed them: every
    split leaf gathered whole, ``_loss_and_grads`` over the full tree, each
    gradient reduce-scattered into the shard, reduced and divided."""
    from repro_torch.models.act_sharding import activation_sharding

    mesh, params = step.mesh, state["params"]

    def whole(p, split):
        out = p.detach()
        for dim, axes in split:
            out = mesh.all_gather(out, axes, dim)
        return out.requires_grad_(True)

    full = [whole(p, s) if s else p for p, s in zip(tree_leaves(params), step._split)]
    with activation_sharding(mesh, step.act_specs):
        loss, _, _, grads = step_mod._loss_and_grads(step.cfg, step.tcfg,
                                                     tree_unflatten(params, full),
                                                     batch["inputs"], batch["labels"])
    with torch.no_grad():
        for i, g in enumerate(grads):
            for dim, axes in step._split[i]:
                g = mesh.reduce_scatter(g, axes, dim)
            if step._reduce_axes[i]:
                mesh.all_reduce(g, step._reduce_axes[i])
            grads[i] = g.div_(step.dp_size)
    return loss, grads


def _bounds(cfg, leaves, splits, world_data):
    """(one layer's gathered bytes plus every split leaf outside the stacks,
    the whole tree's split leaves' bytes), from this rank's shards."""
    paths = [p for p, _ in _paths(step_mod.abstract_params(cfg))]
    layer, top, whole = 0, 0, 0
    for path, leaf, split in zip(paths, leaves, splits):
        if not split:
            continue
        n = leaf.numel() * leaf.element_size()
        for _, axes in split:
            n *= world_data
        whole += n
        if path.startswith("layers/"):
            layer += n // leaf.shape[0]
        else:
            top += n
    return layer + top, whole


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _train_case(arch, remat, micro, shape):
    from repro_torch.launch.mesh import make_mesh

    cfg = configs.smoke_config(arch)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                       compute_dtype="float32", fsdp=True, zero1=True, remat_policy=remat,
                       microbatches=micro)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    step = make_train_step(cfg, tcfg, mesh, device="cpu")
    state = step.init_state(T.init_params(cfg, torch.Generator().manual_seed(0)))
    batch = step.shard_batch(SyntheticDataset(cfg=cfg, seq_len=SEQ, global_batch=BATCH,
                                              seed=0).next_batch())
    loss, _, _, grads = step.grads(state, batch)
    want_loss, want = _whole_tree_grads(step, state, batch)
    bound, whole = _bounds(cfg, tree_leaves(state["params"]), step._split, shape[0])
    return {"loss": (loss, want_loss), "grads": grads, "want": want,
            "live": step.max_live_gathered_bytes, "bound": bound, "whole": whole,
            "split": sum(bool(s) for s in step._split)}


def _serve_case(arch, shape):
    """Prefill + 4 decode steps with FSDP serve weights and without, on the
    same mesh: logits and tokens of each."""
    from repro_torch.launch.mesh import make_mesh

    cfg = configs.smoke_config(arch)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    sshape = ShapeConfig("fsdp", 32, 4, "decode")
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 12), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    out = {}
    for fsdp in (True, False):
        kw = dict(compute_dtype=torch.float32, fsdp=fsdp)
        pre = step_mod.make_prefill_step(cfg, mesh, sshape, **kw)
        dec = step_mod.make_serve_step(cfg, mesh, sshape, **kw)
        local = pre.shard_params(params)
        logits, cache = pre.step(local, pre.shard_inputs(tokens))
        tok = torch.argmax(logits, -1).to(torch.int32)  # vocab whole at model 1
        toks = []
        for _ in range(4):
            tok, cache = dec.step(local, tok, cache)
            toks.append(dec.gather_output(tok))
        splits = [[(d, a) for d, a in step_mod.S._sharded_dims(sp, mesh) if "model" not in a]
                  for sp in tree_leaves(pre.param_specs)]
        bound, whole = _bounds(cfg, tree_leaves(local), splits, shape[0])
        out[fsdp] = {"logits": pre.gather_output(logits), "tokens": toks,
                     "live": max(pre.max_live_gathered_bytes, dec.max_live_gathered_bytes),
                     "bound": bound, "whole": whole}
    return out


def _worker(rank, world, tmp):
    torch.set_num_threads(1)
    from repro_torch.runtime import sharding

    sharding.FSDP_MIN_ELEMENTS = FSDP_MIN
    results = {}
    for w in (4, 2):
        if rank >= w:
            break
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store{w}", rank=rank,
                                world_size=w)
        try:
            for name, arch, remat, micro, shape in TRAIN_CASES[w]:
                results[name] = _train_case(arch, remat, micro, shape)
            for name, arch, shape in SERVE_CASES[w]:
                results[name] = _serve_case(arch, shape)
        finally:
            dist.destroy_process_group()
    torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    ctx = mp.start_processes(_worker, args=(4, str(tmp)), nprocs=4, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish within {SPAWN_TIMEOUT_S} s")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(4)]


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("world", [2, 4], ids=["2ranks", "4ranks"])
def test_layer_gather_matches_whole_tree_gather(spawned, world):
    for name, *_ in TRAIN_CASES[world]:
        for r in range(world):
            res = spawned[r][name]
            assert res["split"] > 0, name
            loss, want_loss = res["loss"]
            assert torch.equal(loss, want_loss), (name, r)
            for i, (g, w) in enumerate(zip(res["grads"], res["want"])):
                if world == 2:
                    assert torch.equal(g, w), (name, r, i, _rel(g, w))
                else:
                    assert _rel(g, w) <= RTOL, (name, r, i, _rel(g, w))
            assert 0 < res["live"] <= res["bound"] < res["whole"], (name, r, res["live"],
                                                                    res["bound"], res["whole"])


@pytest.mark.parametrize("world", [2, 4], ids=["2ranks", "4ranks"])
def test_fsdp_serve_steps_gather_a_layer_at_a_time(spawned, world):
    for name, *_ in SERVE_CASES[world]:
        for r in range(world):
            fsdp, whole = spawned[r][name][True], spawned[r][name][False]
            assert torch.equal(fsdp["logits"], whole["logits"]), (name, r)
            for a, b in zip(fsdp["tokens"], whole["tokens"]):
                assert torch.equal(a, b), (name, r)
            assert whole["live"] == 0  # nothing split, nothing gathered
            assert 0 < fsdp["live"] <= fsdp["bound"] < fsdp["whole"], (name, r, fsdp)
