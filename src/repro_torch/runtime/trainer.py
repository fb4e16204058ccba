"""Fault-tolerant training loop (counterpart of ``repro.runtime.trainer``).

  * checkpoint / restart -- a checkpoint every ``checkpoint_every`` steps
    (written on a thread after a synchronous host copy); when a step fails
    the loop restores the newest complete checkpoint (params, optimizer
    state, error-feedback buffers, data-stream position) and goes on, or
    restarts from the seed when there is none
  * straggler mitigation -- an EMA of the step time; a step slower than
    ``straggler_factor`` times it calls ``on_straggler``, which
    ``specinf_backoff`` turns into SpecInF's filling backoff: the
    collocated-inference token ceiling is halved so the training step is
    not contended while it recovers
  * elastic re-mesh -- ``remesh(new_mesh)`` rebuilds the step on another
    mesh over the same ranks (or on none) and re-shards the live state

The step is the reference's compiled one: ``art.jitted()`` of the
``TrainStepArtifacts`` (``art``) that ``make_train_step`` returns, a CUDA
graph replay on the card (captured at the first step of a state) and the
eager step on the CPU.  ``art`` places the trees (``init_state``,
``shard_state``, ``gather_state``, ``shard_batch``).

On a ``mesh`` (``launch.mesh``) every rank runs the loop: each builds the
same full initial state from the seed and keeps its shards
(``ShardedTrainStep.init_state``), draws the same global batch and feeds
the step its own rows.  A checkpoint is the full state, all-gathered:
rank 0 writes it while the others wait at a barrier, and a restore reads
it on every rank and re-slices it onto the live mesh.  A failure must be
seen by every rank (a step that fails on one rank only leaves the others
in a collective).

The port's step updates the state IN PLACE, and whoever holds the state
(``SpecInFRuntime``, the CLI) holds its tensors: a restore or a restart
copies into the live tensors and never rebinds them, so the step's graph
keeps replaying.  A remesh changes the shards' shapes, so it puts the new
tensors into the live state's dicts; the old tensors die, and the graph
keyed by them with them.

One deliberate difference from the reference (ROADMAP C11): a failure that
repeats at the same step right after a restore is raised, not retried.  The
reference restores and retries forever; on the card a kernel that fails to
build or launch would turn into a silent endless restart.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data import SyntheticDataset
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.runtime.step import make_train_step
from repro_torch.tree import tree_map

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainerReport:
    steps: int = 0
    losses: list = dataclasses.field(default_factory=list)
    step_times_s: list = dataclasses.field(default_factory=list)
    restores: int = 0
    straggler_events: int = 0
    checkpoints: int = 0


@torch.no_grad()
def _copy_into(live: dict, new: dict) -> None:
    """Copy every leaf of ``new`` into the matching tensor of ``live``."""
    def copy(dst: torch.Tensor, src: torch.Tensor) -> None:
        if dst.shape != src.shape:
            raise ValueError(f"restored leaf {tuple(src.shape)} does not match the live "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)

    tree_map(copy, live, new)


def _rebind_into(live: dict, new: dict) -> None:
    """Put every leaf of ``new`` into ``live``'s dicts (shapes may change)."""
    for k, v in new.items():
        if isinstance(v, dict):
            _rebind_into(live.setdefault(k, {}), v)
        else:
            live[k] = v


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainConfig,
        mesh=None,
        *,
        seq_len: int,
        global_batch: int,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 50,
        straggler_factor: float = 3.0,
        on_straggler: Optional[Callable[[], None]] = None,
        host_index: int = 0,
        host_count: int = 1,
        device: Optional[str | torch.device] = None,
    ):
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.seq_len, self.global_batch = seq_len, global_batch
        self.device = resolve_device(device)
        self.art = make_train_step(cfg, tcfg, mesh, device=self.device)
        self.step_fn = self.art.jitted()
        self.dataset = SyntheticDataset(
            cfg=cfg, seq_len=seq_len, global_batch=global_batch,
            host_index=host_index, host_count=host_count, seed=tcfg.seed,
        )
        self.state = self._init_state()
        self.step_no = 0
        self.ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_every = checkpoint_every
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler
        self._ema: Optional[float] = None
        self._failed_at: Optional[int] = None
        self.report = TrainerReport()
        # failure-injection hook for tests: callable(step_no) -> bool
        self.fail_hook: Optional[Callable[[int], bool]] = None

    def _init_state(self) -> dict:
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        params = T.init_params(self.cfg, gen, dtype=getattr(torch, self.tcfg.param_dtype))
        return self.art.init_state(params)

    def full_state(self) -> dict:
        """The full state: the live one without a mesh, else all-gathered
        from every rank's shards (a collective: every rank calls it)."""
        if self.mesh is None:
            return self.state
        return self.art.gather_state(self.state)

    # ------------------------------------------------------------------
    def _snapshot(self) -> dict:
        return {"state": self.full_state(), "data_step": np.int64(self.dataset._step)}

    def _save(self, blocking: bool) -> None:
        """Rank 0 writes the full state; the others wait at a barrier."""
        snap = self._snapshot()
        if self.mesh is None or self.mesh.rank == 0:
            self.ckpt.save(self.step_no, snap, blocking=blocking)
        if self.mesh is not None:
            dist.barrier()
        self.report.checkpoints += 1

    def _maybe_checkpoint(self) -> None:
        if self.ckpt and self.step_no % self.checkpoint_every == 0:
            self._save(blocking=False)

    def restore_latest(self) -> bool:
        """Copy the newest complete checkpoint into the live state (after
        any save in flight lands; on a mesh re-sliced to this rank's
        shards); False when there is none."""
        if not self.ckpt:
            return False
        self.ckpt.wait()
        if self.mesh is not None:
            dist.barrier()  # rank 0's save in flight has landed
        if self.ckpt.latest_step() is None:
            return False
        template = {"state": self.state, "data_step": np.int64(self.dataset._step)}
        restored, step = self.ckpt.restore(template)
        full = restored["state"]
        _copy_into(self.state, full if self.mesh is None else self.art.shard_state(full))
        self.dataset._step = int(restored["data_step"])
        self.step_no = step
        self.report.restores += 1
        return True

    def _restart(self) -> None:
        """No checkpoint yet: back to the seed's initial state, in place."""
        _copy_into(self.state, self._init_state())
        self.dataset._step = 0
        self.step_no = 0
        self.report.restores += 1

    # ------------------------------------------------------------------
    def _batch(self) -> dict:
        """The next batch, on a mesh this rank's rows of it."""
        return self.art.shard_batch(self.dataset.next_batch())

    def train(self, num_steps: int) -> TrainerReport:
        target = self.step_no + num_steps
        while self.step_no < target:
            batch = self._batch()
            t0 = time.monotonic()
            try:
                if self.fail_hook and self.fail_hook(self.step_no):
                    raise RuntimeError(f"injected failure @ step {self.step_no}")
                self.state, metrics = self.step_fn(self.state, batch)
                loss = float(metrics["loss"])  # waits for the device
            except Exception as exc:
                if self._failed_at == self.step_no:
                    raise RuntimeError(
                        f"step {self.step_no} failed again right after a restore"
                    ) from exc
                log.warning("step %d failed; restoring", self.step_no, exc_info=True)
                self._failed_at = self.step_no
                if not self.restore_latest():
                    self._restart()
                continue
            dt = time.monotonic() - t0
            self.step_no += 1
            if self._failed_at is not None and self.step_no > self._failed_at:
                self._failed_at = None
            self.report.steps += 1
            self.report.losses.append(loss)
            self.report.step_times_s.append(dt)
            # straggler detection on the step-time EMA
            if self._ema is not None and dt > self.straggler_factor * self._ema:
                self.report.straggler_events += 1
                if self.on_straggler:
                    self.on_straggler()
            self._ema = dt if self._ema is None else 0.9 * self._ema + 0.1 * dt
            self._maybe_checkpoint()
        if self.ckpt:
            self._save(blocking=True)
        return self.report

    # ------------------------------------------------------------------
    def remesh(self, new_mesh) -> None:
        """Elastic scaling: rebuild the step on ``new_mesh`` (over the same
        ranks; None for one device) and re-shard the live state onto it.
        The state's dicts stay the caller's; their leaves are new tensors
        where the shards' shapes change."""
        full = self.full_state()
        self.art = make_train_step(self.cfg, self.tcfg, new_mesh, device=self.device)
        self.step_fn = self.art.jitted()
        self.mesh = new_mesh
        new = self.art.shard_state(full)
        del full
        _rebind_into(self.state, new)


def specinf_backoff(scheduler) -> Callable[[], None]:
    """Straggler -> filling backoff: halve the collocated-inference token
    ceiling on the live Algorithm-1 scheduler (restored by the next
    conservative->stable cycle's config)."""

    def backoff():
        scheduler._tokens = scheduler._tokens / 2.0

    return backoff
