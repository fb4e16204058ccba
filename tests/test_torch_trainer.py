"""The port's training substrate and fault-tolerant ``Trainer``, on the CPU.

* ``SyntheticDataset`` sharded over two hosts, after ``restore()``, and
  ``make_train_iterator`` give the reference's batches exactly; the shape
  set is the reference's.
* ``Checkpointer.latest_step`` skips torn saves; a restore keeps a 0-d
  tensor's shape, dtype and device.
* The ``Trainer`` (the reference's own ``Trainer`` cannot run on the
  installed JAX, ROADMAP C1, so it is held to the port's step): its losses
  and final state are bit-equal to a plain loop of ``make_train_step``;
  after an injected failure it resumes from its checkpoint bit-equal to
  the uninterrupted run (with and without int8 error feedback), or
  restarts from the seed when it has no checkpoint; a failure repeated at
  the same step right after a restore is raised (C11); a step slowed on
  the trainer's clock fires ``specinf_backoff``, which halves the
  scheduler's token ceiling; ``remesh`` onto a one-rank mesh and back
  keeps the state (the multi-rank round trips are in
  ``test_torch_dist_step.py``).
"""
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.data.pipeline import make_train_iterator as jmake_train_iterator
from repro_torch import configs
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import SHAPES, ShapeConfig, SpecInFConfig, TrainConfig
from repro_torch.core import AdaptiveKernelScheduler
from repro_torch.data import SyntheticDataset, make_train_iterator
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import transformer as T
from repro_torch.runtime import (
    ShardedTrainStep,
    Trainer,
    init_train_state,
    make_train_step,
    specinf_backoff,
)
from repro_torch.runtime import trainer as trainer_module
from repro_torch.tree import tree_leaves, tree_map

ARCH = "qwen3-1.7b"
SEQ, BATCH = 16, 2
TRAIN_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _equal_batches(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# data, shapes, checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "musicgen-large"])
def test_host_sharded_dataset_equals_reference(arch):
    jcfg, cfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    for host in (0, 1):
        jds = JDataset(jcfg, seq_len=8, global_batch=4, host_index=host, host_count=2, seed=3)
        tds = SyntheticDataset(cfg, seq_len=8, global_batch=4, host_index=host, host_count=2,
                               seed=3)
        assert tds.local_batch == jds.local_batch == 2
        for _ in range(2):
            _equal_batches(tds.next_batch(), jds.next_batch())
    with pytest.raises(ValueError, match="hosts"):
        SyntheticDataset(cfg, seq_len=8, global_batch=3, host_count=2)


def test_dataset_restore_and_iterator_equal_reference():
    jcfg, cfg = jconfigs.smoke_config(ARCH), configs.smoke_config(ARCH)
    tds = SyntheticDataset(cfg, seq_len=8, global_batch=4, seed=5)
    for _ in range(3):
        tds.next_batch()
    assert tds.state() == {"step": 3}
    jds = JDataset(jcfg, seq_len=8, global_batch=4, seed=5)
    jds.restore({"step": 3})
    fresh = SyntheticDataset(cfg, seq_len=8, global_batch=4, seed=5)
    fresh.restore(tds.state())
    _equal_batches(fresh.next_batch(), jds.next_batch())
    _equal_batches(tds.next_batch(),
                   JDataset(jcfg, seq_len=8, global_batch=4, seed=5, _step=3).next_batch())

    shape = ShapeConfig("tiny", seq_len=8, global_batch=4, kind="train")
    jshape = jbase.ShapeConfig("tiny", seq_len=8, global_batch=4, kind="train")
    ds, it = make_train_iterator(cfg, shape, host_index=1, host_count=2, seed=2)
    jds, jit = jmake_train_iterator(jcfg, jshape, host_index=1, host_count=2, seed=2)
    assert (ds.seq_len, ds.global_batch, ds.local_batch) == (8, 4, 2)
    for _ in range(2):
        _equal_batches(next(it), next(jit))
    assert ds.state() == jds.state() == {"step": 2}


def test_shapes_equal_reference():
    assert {k: vars(v) for k, v in SHAPES.items()} == {
        k: vars(v) for k, v in jbase.SHAPES.items()}
    assert SHAPES["decode_32k"].is_decode and not SHAPES["train_4k"].is_decode


def test_latest_step_and_zero_dim_restore(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() is None
    tree = {"step": torch.tensor(7, dtype=torch.int32), "w": torch.ones(3)}
    ck.save(2, tree)
    ck.save(5, tree, blocking=False)
    ck.wait()
    assert ck.latest_step() == 5
    (tmp_path / "step_00000009").mkdir()  # torn: no manifest
    assert ck.latest_step() == 5
    restored, step = ck.restore({"step": torch.zeros((), dtype=torch.int32),
                                 "w": torch.zeros(3)})
    assert step == 5
    assert restored["step"].shape == () and restored["step"].dtype == torch.int32
    assert restored["step"].item() == 7 and restored["step"].device.type == "cpu"


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _trainer(tmp_path=None, every=2, compression="none", **kw):
    cfg = configs.smoke_config(ARCH)
    tcfg = TrainConfig(**TRAIN_KW, grad_compression=compression)
    return Trainer(cfg, tcfg, seq_len=SEQ, global_batch=BATCH, device="cpu",
                   checkpoint_dir=None if tmp_path is None else str(tmp_path),
                   checkpoint_every=every, **kw)


def _assert_same_state(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach())


def test_trainer_bit_equal_to_plain_step_loop():
    trainer = _trainer()
    report = trainer.train(4)
    assert report.steps == 4 and trainer.step_no == 4 and report.restores == 0
    assert len(report.step_times_s) == 4 and all(t > 0 for t in report.step_times_s)

    cfg = configs.smoke_config(ARCH)
    tcfg = TrainConfig(**TRAIN_KW)
    step = make_train_step(cfg, tcfg, device="cpu")
    state = init_train_state(T.init_params(cfg, torch.Generator("cpu").manual_seed(tcfg.seed)))
    ds = SyntheticDataset(cfg, seq_len=SEQ, global_batch=BATCH, seed=tcfg.seed)
    losses = []
    for _ in range(4):
        state, m = step(state, ds.next_batch())
        losses.append(float(m["loss"]))
    assert report.losses == losses
    _assert_same_state(trainer.state, state)
    for p in tree_leaves(trainer.state["params"]):
        assert p.requires_grad


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
def test_trainer_resumes_bit_equal_after_injected_failure(tmp_path, compression):
    clean = _trainer(compression=compression)
    clean_report = clean.train(6)

    trainer = _trainer(tmp_path, every=2, compression=compression)
    live = {id(t) for t in tree_leaves(trainer.state)}
    fired = []

    def fail_once_at_5(step_no):
        if step_no == 5 and not fired:
            fired.append(step_no)
            return True
        return False

    trainer.fail_hook = fail_once_at_5
    report = trainer.train(6)
    assert fired == [5] and report.restores == 1
    # checkpoints at 2 and 4 (the one at 4 read back), 6 and the final save
    assert report.checkpoints == 4 and trainer.ckpt.latest_step() == 6
    # steps 0-4, then step 4 again from its checkpoint, then 5
    assert report.losses[:5] == clean_report.losses[:5]
    assert report.losses[5:] == clean_report.losses[4:]
    _assert_same_state(trainer.state, clean.state)
    # the live tensors were restored in place, not replaced
    assert {id(t) for t in tree_leaves(trainer.state)} - {id(trainer.state["opt"]["step"])} \
        <= live
    if compression == "int8_ef":
        assert any(e.any() for e in tree_leaves(trainer.state["err"]))

    # a fresh trainer on the same directory resumes from the final save
    again = _trainer(tmp_path, compression=compression)
    assert again.restore_latest() and again.step_no == 6
    _assert_same_state(again.state, clean.state)
    assert again.dataset._step == clean.dataset._step == 6


def test_trainer_restarts_from_scratch_without_checkpoint():
    clean = _trainer()
    clean_report = clean.train(4)
    trainer = _trainer()
    fired = []
    trainer.fail_hook = lambda s: s == 2 and not fired and not fired.append(s)
    report = trainer.train(4)
    assert report.restores == 1 and trainer.step_no == 4
    assert report.losses == clean_report.losses[:2] + clean_report.losses
    _assert_same_state(trainer.state, clean.state)


@pytest.mark.parametrize("with_checkpoint", [True, False])
def test_repeated_failure_after_restore_is_raised(tmp_path, with_checkpoint):
    trainer = _trainer(tmp_path if with_checkpoint else None, every=1)
    at = 1 if with_checkpoint else 0
    trainer.fail_hook = lambda s: s == at
    with pytest.raises(RuntimeError, match=f"step {at} failed again") as info:
        trainer.train(3)
    assert "injected failure" in str(info.value.__cause__)
    assert trainer.report.restores == 1 and trainer.step_no == at


def test_slow_step_fires_specinf_backoff(monkeypatch, tmp_path):
    sched = AdaptiveKernelScheduler(SpecInFConfig(), num_instances=1)
    sched._tokens = 64.0
    events = []
    backoff = specinf_backoff(sched)
    trainer = _trainer(on_straggler=lambda: (events.append(trainer.step_no), backoff()))
    step = trainer.step_fn
    # step 4 takes 100 s more on the trainer's clock, whatever the machine's load
    lag = [0.0]
    clock = time.monotonic
    monkeypatch.setattr(trainer_module.time, "monotonic", lambda: clock() + lag[0])

    def slowed(state, batch):
        if trainer.step_no == 4:
            lag[0] += 100.0
        return step(state, batch)

    trainer.step_fn = slowed
    report = trainer.train(6)
    assert 5 in events and report.straggler_events == len(events)
    assert sched._tokens == 64.0 / 2 ** len(events)
    # remesh re-shards the live state: onto a one-rank mesh and back
    full = {k: tree_map(lambda t: t.detach().clone(), v) for k, v in trainer.state.items()}
    live = trainer.state
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        trainer.remesh(make_dev_mesh(device="cpu"))
        assert isinstance(trainer.step_fn, ShardedTrainStep) and trainer.state is live
        _assert_same_state(trainer.state, full)
        trainer.remesh(None)
        assert trainer.mesh is None and trainer.state is live
        _assert_same_state(trainer.state, full)
    finally:
        dist.destroy_process_group()
