"""Training CLI of the port: the fault-tolerant ``Trainer`` end to end over
a mesh, with optional SpecInF collocation.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --seq-len 1024 \\
      --global-batch 4 --steps 6
  PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.train --arch olmo-1b \\
      --seq-len 1024 --global-batch 8 --steps 6
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke --device cpu \\
      --steps 20 --global-batch 8 --seq-len 64 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 4 --collocate

Counterpart of ``repro.launch.train``, with its flags and defaults.
``--smoke`` selects the reduced config (remat ``"dots"``); without it the
full architecture trains under remat ``"full"`` with FSDP and ZeRO-1.  The
mesh is ``make_dev_mesh()`` with ``data`` the world size: the ranks torchrun
starts (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``), or one
rank over an in-process store without torchrun.  ``--production-mesh``
builds the 16x16 mesh instead, which needs 256 ranks: the default layout
``"tp"`` then runs the attention families with tensor, expert and vocab
parallelism over ``model = 16`` (Mamba1 and the hybrid raise
``NotImplementedError`` until the next scale-out slice).  The run is on
``cuda`` unless ``--device cpu`` is given; without a CUDA device the
default raises.  ``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps
and resumes from the newest checkpoint there (rank 0 writes it: the
directory must be the same for every rank).  ``--collocate`` runs the
trainer's step under ``SpecInFRuntime``, its bubbles filled by an engine
serving the weights the run starts from (an offline backlog of 4
requests); the DP profile and the engine microstep are measured on the
device (``measure_dp_profile``: two calibration steps, which train too).
Only rank 0 prints.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs import SpecInFConfig, TrainConfig
from repro_torch.device import synchronize
from repro_torch.launch.mesh import init_distributed, make_dev_mesh, make_production_mesh
from repro_torch.runtime.trainer import Trainer


def _peak(device: torch.device) -> str:
    if device.type != "cuda":
        return ""
    return f" peak {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB"


def main(argv: Optional[list] = None):
    """Runs the CLI on ``argv`` (``sys.argv`` when None); returns the
    ``TrainerReport``, or the ``FillingMetrics`` under ``--collocate``."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(configs.ARCH_IDS), default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh (256 ranks; layout 'tp': model 16)")
    ap.add_argument("--collocate", action="store_true",
                    help="fill training bubbles with a collocated inference "
                         "engine (SpecInF)")
    args = ap.parse_args(argv)
    created = init_distributed(args.device)
    try:
        return _run(args)
    finally:
        if created:
            dist.destroy_process_group()


def _run(args):
    cfg = configs.smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    tcfg = TrainConfig(
        learning_rate=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps, microbatches=args.microbatches,
        remat_policy="dots" if args.smoke else "full",
        fsdp=not args.smoke, zero1=not args.smoke,
    )
    if args.production_mesh:
        mesh = make_production_mesh(device=args.device)
    else:
        mesh = make_dev_mesh(data=dist.get_world_size(), device=args.device)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    trainer = Trainer(
        cfg, tcfg, mesh, seq_len=args.seq_len, global_batch=args.global_batch,
        checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every,
        device=mesh.device,
    )
    if args.ckpt_dir and trainer.restore_latest():
        say(f"[train] resumed from step {trainer.step_no}")
    if trainer.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(trainer.device)

    if args.collocate:
        return _train_collocated(args, cfg, trainer, say)

    t0 = time.time()
    report = trainer.train(args.steps)
    synchronize(trainer.device)
    dt = time.time() - t0
    toks = report.steps * args.global_batch * args.seq_len
    say(
        f"[train] {report.steps} steps in {dt:.1f}s "
        f"({toks / dt:.0f} tok/s) loss {report.losses[0]:.3f} -> "
        f"{report.losses[-1]:.3f} restores={report.restores} "
        f"checkpoints={report.checkpoints} mesh={mesh.shape}{_peak(trainer.device)}"
    )
    return report


def _train_collocated(args, cfg, trainer, say):
    """SpecInF end to end: the trainer's real step runs under the
    speculative-filling runtime with a real inference engine (one on each
    rank)."""
    from repro_torch.core import SpecInFRuntime, measure_dp_profile
    from repro_torch.serving.core import Priority, SamplingParams
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.tree import tree_map

    # the engine serves a copy of the full weights the run starts from: the
    # step trains the trainer's tensors (or shards) in place
    params = tree_map(lambda p: p.detach().clone(), trainer.full_state()["params"])
    engine = InferenceEngine(cfg, params, max_slots=4, max_seq=args.seq_len,
                             device=trainer.device)
    del params

    def batches():
        while True:
            yield trainer._batch()

    batch_iter = batches()
    profile, microstep_s = measure_dp_profile(cfg.name, trainer.step_fn, trainer.state,
                                              batch_iter, engine)
    say(f"[train+fill] measured: train step {profile.compute_s * 1e3:.1f} ms, decode "
        f"microstep {microstep_s * 1e3:.1f} ms")
    for _ in range(4):
        engine.core.submit(np.arange(8) % cfg.vocab_size,
                           SamplingParams(max_new_tokens=engine.max_seq - 8),
                           priority=Priority.OFFLINE)
    rt = SpecInFRuntime(
        train_step=trainer.step_fn, train_state=trainer.state, batch_iter=batch_iter,
        profile=profile, engine=engine, cfg=SpecInFConfig(),
        decode_microstep_s=microstep_s,
    )
    t0 = time.time()
    metrics = rt.run(args.steps)
    synchronize(trainer.device)
    dt = time.time() - t0
    toks = metrics.train_iterations * args.global_batch * args.seq_len
    say(
        f"[train+fill] {metrics.train_iterations} train steps, "
        f"{metrics.offline_tokens_generated} collocated inference tokens "
        f"in {dt:.1f}s ({toks / dt:.0f} train tok/s); loss "
        f"{metrics.train_losses[0]:.3f} -> {metrics.train_losses[-1]:.3f}; "
        f"phases={metrics.phase_counts}{_peak(trainer.device)}"
    )
    return metrics


if __name__ == "__main__":
    main()
