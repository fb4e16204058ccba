"""SpecInF with the PyTorch / CUDA port: a real training loop collocated
with a real continuous-batching inference engine, its bubbles filled under
Algorithm 1 (the port's counterpart of ``examples/collocated_training.py``).

  PYTHONPATH=src python examples/torch_collocated_training.py                 # qwen3-1.7b, cuda
  PYTHONPATH=src python examples/torch_collocated_training.py --device cpu --smoke

``--smoke`` runs the 2-layer smoke config of the arch.  The run reports
(a) training progress, (b) offline inference tokens produced inside
training bubbles, (c) the Algorithm-1 phase distribution and (d) the
profile's bubble fraction against the share of the virtual time the
filled microsteps took.  The virtual clock runs in the device's own units:
``measure_dp_profile`` times one train step (compute; communication is
half of it, the reference example's ratio) and one fused decode
microstep of the engine, and the two calibration steps train too.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs import SpecInFConfig, TrainConfig
from repro_torch.core import (
    InstanceProfile,
    SpecInFRuntime,
    measure_dp_profile,
    plan_collocation,
)
from repro_torch.data import SyntheticDataset
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import transformer as T
from repro_torch.runtime import init_train_state, make_train_step
from repro_torch.serving.core import Priority, SamplingParams
from repro_torch.serving.engine import InferenceEngine
from repro_torch.tree import tree_leaves


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(configs.ARCH_IDS), default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", help="2-layer smoke config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq-len", type=int, default=None,
                    help="default 1024 (64 with --smoke)")
    ap.add_argument("--global-batch", type=int, default=None,
                    help="default 4 (8 with --smoke)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = configs.smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    seq_len = args.seq_len or (64 if args.smoke else 1024)
    batch = args.global_batch or (8 if args.smoke else 4)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=args.steps)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    params = T.init_params(cfg, gen, dtype=getattr(torch, tcfg.param_dtype))
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {cfg.name} ({n_params / 1e6:.1f}M params) on {device}")

    # the engine serves the initial weights; the train state owns a copy
    engine = InferenceEngine(cfg, params, max_slots=4, max_seq=min(seq_len, 256),
                             device=device)
    state = init_train_state(params)
    del params
    # the reference's compiled step: a CUDA graph replay on the card
    step = make_train_step(cfg, tcfg, device=device).jitted()
    ds = SyntheticDataset(cfg, seq_len=seq_len, global_batch=batch)

    def batches():
        while True:
            yield ds.next_batch()

    # --- collocation planning (Principles I & II) -------------------------
    spec_cfg = SpecInFConfig()
    batch_iter = batches()
    profile, microstep_s = measure_dp_profile(cfg.name, step, state, batch_iter, engine)
    print(f"measured: train step {profile.compute_s * 1e3:.1f} ms, decode microstep "
          f"{microstep_s * 1e3:.1f} ms")
    if microstep_s * 1e3 > spec_cfg.upper_limit:
        print(f"note: one microstep costs more than Algorithm 1's cap of "
              f"{spec_cfg.upper_limit:g} tokens (1 token = 1 ms): no offline "
              f"quantum is ever granted")
    training = profile.as_training_profile(peak_memory_bytes=2 * 1024**3)
    candidates = [
        InstanceProfile(f"{cfg.name}-serve-{i}", 512 * 1024**2,
                        min_exec_time_s=microstep_s)
        for i in range(2)
    ]
    plan = plan_collocation(training, candidates, spec_cfg)
    print(f"collocation: accepted {plan.num_instances} inference instances, "
          f"total {plan.total_memory_bytes / 2**30:.1f} GiB "
          f"(limit {spec_cfg.hbm_limit_bytes / 2**30:.0f} GiB)")

    # --- offline backlog: waits until Algorithm 1's grant affords it -------
    for _ in range(4):
        engine.core.submit(np.arange(8) % cfg.vocab_size,
                           SamplingParams(max_new_tokens=engine.max_seq - 8),
                           priority=Priority.OFFLINE)

    rt = SpecInFRuntime(
        train_step=step, train_state=state, batch_iter=batch_iter, profile=profile,
        engine=engine, cfg=spec_cfg, decode_microstep_s=microstep_s,
    )
    t0 = time.time()
    metrics = rt.run(args.steps)
    synchronize(device)
    dt = time.time() - t0

    print(f"\n== SpecInF collocated run ({dt:.1f}s wall) ==")
    print(f"train: {metrics.train_iterations} steps, "
          f"loss {metrics.train_losses[0]:.3f} -> {metrics.train_losses[-1]:.3f}")
    print(f"filling: {metrics.offline_tokens_generated} inference tokens in "
          f"{metrics.offline_microsteps} microsteps inside bubbles")
    total = sum(metrics.phase_counts.values())
    print("algorithm-1 phases:",
          {k: f"{v / total:.1%}" for k, v in metrics.phase_counts.items()})
    filled = metrics.offline_microsteps * microstep_s
    print(f"profile bubble fraction: {profile.bubble_fraction:.1%} -> virtual "
          f"aggregated utilization gain {filled / max(metrics.virtual_time_s, 1e-9):.1%}")


if __name__ == "__main__":
    main()
