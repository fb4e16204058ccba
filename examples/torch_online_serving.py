"""Online inference filling with the PyTorch / CUDA port: Poisson ONLINE
requests served inside training bubbles via pull-and-execute (paper §3.3;
the port's counterpart of ``examples/online_serving.py``).

  PYTHONPATH=src python examples/torch_online_serving.py               # cuda
  PYTHONPATH=src python examples/torch_online_serving.py --device cpu

The trainer runs under ``SpecInFRuntime`` with
``SpecInFConfig(busy_hold_ms=5.0)``; the arrivals go straight into
``engine.core`` with their arrival times on the runtime's virtual clock, so
Algorithm 1's policy pulls them inside idle windows (and preempts offline
slots if capacity ever blocks one).  The script runs the 2-layer smoke
olmo-1b over a fixed profile (50 ms compute, 40 ms communication, a 2 ms
microstep); ``run`` also takes a full-size config and, with ``profile``
None, measures the profile and the microstep on the device
(``measure_dp_profile``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs import SpecInFConfig, TrainConfig
from repro_torch.core import SpecInFRuntime, dp_profile, measure_dp_profile
from repro_torch.data import SyntheticDataset
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import transformer as T
from repro_torch.runtime import init_train_state, make_train_step
from repro_torch.serving.core import Priority, SamplingParams
from repro_torch.serving.engine import InferenceEngine


#: mean gap between two Poisson ONLINE arrivals (virtual seconds)
MEAN_INTERVAL_S = 0.05


def run(cfg, device, profile=None, microstep_s=None, *, tcfg=None, seq_len=48,
        global_batch=4, max_seq=48, iterations=12, num_requests=12):
    """Train ``iterations`` steps of ``cfg`` on ``device`` under
    ``SpecInFRuntime`` while ``num_requests`` Poisson ONLINE requests (6
    prompt tokens, 4 new) arrive ``MEAN_INTERVAL_S`` apart on average.

    ``profile`` / ``microstep_s``: the iteration profile and the engine's
    decode microstep the runtime's virtual clock runs on; with ``profile``
    None both are measured here (``measure_dp_profile``: two train steps,
    then a microstep probe over the engine's 2 slots, which needs
    ``max_seq`` >= 49).  Returns
    ``(metrics, requests, profile, microstep_s)``."""
    device = torch.device(device)
    tcfg = tcfg or TrainConfig(learning_rate=1e-3)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    params = T.init_params(cfg, gen, dtype=getattr(torch, tcfg.param_dtype))
    # the engine serves the initial weights; the train state owns a copy
    engine = InferenceEngine(cfg, params, max_slots=2, max_seq=max_seq, device=device)
    state = init_train_state(params)
    del params
    # the reference's compiled step: a CUDA graph replay on the card
    step = make_train_step(cfg, tcfg, device=device).jitted()
    ds = SyntheticDataset(cfg, seq_len=seq_len, global_batch=global_batch)
    batches = (ds.next_batch() for _ in iter(int, 1))
    if profile is None:
        profile, microstep_s = measure_dp_profile(cfg.name, step, state, batches, engine,
                                                  probe_slots=engine.max_slots)
    rt = SpecInFRuntime(
        train_step=step, train_state=state, batch_iter=batches, profile=profile,
        engine=engine, cfg=SpecInFConfig(busy_hold_ms=5.0), decode_microstep_s=microstep_s,
    )
    # submitted after the runtime is built: it restamps requests already
    # queued to its virtual epoch
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(MEAN_INTERVAL_S, num_requests))
    requests = [
        engine.core.submit(
            rng.integers(0, cfg.vocab_size, 6),
            SamplingParams(max_new_tokens=4),
            priority=Priority.ONLINE, arrival_time=float(t),
        )
        for t in arrivals
    ]
    metrics = rt.run(num_iterations=iterations)
    synchronize(device)
    return metrics, requests, profile, microstep_s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.smoke_config("olmo-1b")
    profile = dp_profile(cfg.name, compute_s=0.05, comm_s=0.04)
    t0 = time.time()
    m, requests, _, _ = run(cfg, device, profile, 0.002)
    print(f"trained {m.train_iterations} iterations "
          f"(loss {m.train_losses[0]:.3f} -> {m.train_losses[-1]:.3f}) in "
          f"{time.time() - t0:.1f}s wall")
    print(f"online: served {m.online_served}/{len(requests)} requests inside "
          f"bubbles, p95 latency {m.p95_latency_s() * 1e3:.1f} ms, "
          f"p95 TTFT {m.p95_ttft_s() * 1e3:.1f} ms (virtual)")
    print("phases:", m.phase_counts)
    return m, requests


if __name__ == "__main__":
    main()
