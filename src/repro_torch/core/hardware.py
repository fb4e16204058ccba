"""Accelerator hardware constants for analytic profiles (own copy of
``repro.core.hardware``, plus the H100 the port runs on)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float  # bf16 FLOP/s per chip
    hbm_bandwidth: float  # bytes/s per chip
    link_bandwidth: float  # bytes/s per ICI/NVLink link
    hbm_bytes: int
    mfu_assumption: float = 0.4  # sustained fraction for analytic time estimates


# TPU v5e -- the reference's deployment target.
V5E = HardwareSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bandwidth=819e9,
    link_bandwidth=50e9,
    hbm_bytes=16 * 1024**3,
)

# A100-40GB -- the paper's testbed.
A100_40G = HardwareSpec(
    name="a100-40g",
    peak_flops=312e12,
    hbm_bandwidth=1555e9,
    link_bandwidth=300e9,
    hbm_bytes=40 * 1024**3,
)

# H100 SXM (NVIDIA data sheet; the part `nvidia-smi` names "NVIDIA H100 80GB
# HBM3" at a 700 W power limit): dense bf16 peak, HBM3 rate, NVLink 4's
# 900 GB/s total halved to one direction (A100_40G's 300e9 is A100's
# 600 GB/s the same way), and SpecInFConfig.hbm_limit_bytes' 80 GB.
H100 = HardwareSpec(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bandwidth=3.35e12,
    link_bandwidth=450e9,
    hbm_bytes=80 * 10**9,
)
