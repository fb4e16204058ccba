"""The card: the check that one is there, its name and power limit, and
the cache directories a run keeps inside its checkout."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import torch


def require(chips: int) -> None:
    """Exit with code 2, printing no result, unless CUDA offers ``chips``
    cards: the benchmark has no CPU path."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: this cell needs {chips} CUDA device(s); found {have}", file=sys.stderr)
        sys.exit(2)


def card() -> str:
    """``nvidia-smi``'s name and power limit of card 0 (the numbers mean
    nothing without them), or what torch knows when it cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
        return out or torch.cuda.get_device_name(0)
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def keep_caches_in(checkout: Path) -> None:
    """Point every compile cache that torch or Triton might open at fixed
    directories inside the checkout (the port's own nvcc libraries already
    live in its ``build/kernels``)."""
    base = checkout / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)
    # a library the port uses must not load JAX by itself
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
