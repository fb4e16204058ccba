"""Quickstart with the PyTorch / CUDA port: build an assigned architecture,
train a few steps, decode (the port's counterpart of
``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py                     # qwen3-1.7b smoke, cuda
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu [--arch olmo-1b]

Runs the REDUCED (smoke) config, as the reference's quickstart does; the
run is on ``cuda`` unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs import TrainConfig
from repro_torch.data import SyntheticDataset
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.runtime import init_train_state, make_train_step
from repro_torch.serving.core import Priority, SamplingParams
from repro_torch.serving.engine import InferenceEngine
from repro_torch.tree import tree_map


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list(configs.ARCH_IDS))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.smoke_config(args.arch)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=args.steps)

    # ---- train a few steps -------------------------------------------------
    # the reference's compiled step: a CUDA graph replay on the card
    step = make_train_step(cfg, tcfg, device=device).jitted()
    state = init_train_state(T.init_params(cfg, torch.Generator(device).manual_seed(0)))
    ds = SyntheticDataset(cfg, seq_len=64, global_batch=8)
    for i in range(args.steps):
        state, m = step(state, ds.next_batch())
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.2f}")

    # ---- greedy decode through the engine lifecycle core ------------------
    # submit() queues the request; stream() yields tokens as EngineCore.step()
    # quanta produce them (prefill -> first token, fused decode -> the rest).
    # The engine serves the trained weights (detached from autograd), cast to
    # its compute dtype (bf16).
    params = tree_map(lambda p: p.detach(), state["params"])
    engine = InferenceEngine(cfg, params, max_slots=1, max_seq=32, device=device)
    prompt = np.arange(8) % cfg.vocab_size
    req = engine.core.submit(
        prompt, SamplingParams(max_new_tokens=9), priority=Priority.ONLINE
    )
    out = list(engine.core.stream(req))
    print("prompt:", prompt.tolist())
    print("generated:", out, f"({req.finish_reason})")
    return out


if __name__ == "__main__":
    main()
