"""Training-iteration profiles (own copy of ``repro.core.profiles``'s
``IterationProfile`` and its segment constructors).

The caller sizes a profile from what it measured (``measure_dp_profile``
times the train step and the engine's microstep on the device):
``SpecInFRuntime`` runs its virtual clock through the profile's segments.
The analytic profiles (6ND-style napkin math over a ``HardwareSpec``,
``core.hardware``'s ``H100`` among them) size a profile from a
``ModelConfig`` alone, as the reference's paper-fidelity rows do.

A profile is the per-iteration segment structure one accelerator observes:
alternating (compute | bubble) spans.  Parallel modes shape it differently
(paper §2.1): DP exposes one gradient-sync tail bubble; MP/TP exposes
many short per-layer collective bubbles; PP exposes per-microbatch gaps
plus warmup/drain bubbles.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collocation import InstanceProfile, TrainingProfile
from repro_torch.core.hardware import HardwareSpec
from repro_torch.device import synchronize
from repro_torch.serving.core import DECODE_K_BUCKETS, Priority, SamplingParams

Segment = tuple[str, float]  # ("compute" | "bubble", seconds)


@dataclasses.dataclass(frozen=True)
class IterationProfile:
    """One training iteration's segment timeline on a single accelerator."""

    name: str
    segments: tuple[Segment, ...]
    mode: str  # "dp" | "mp" | "pp"

    @property
    def iteration_s(self) -> float:
        return sum(d for _, d in self.segments)

    @property
    def compute_s(self) -> float:
        return sum(d for k, d in self.segments if k == "compute")

    @property
    def bubble_s(self) -> float:
        return sum(d for k, d in self.segments if k == "bubble")

    @property
    def bubble_fraction(self) -> float:
        return self.bubble_s / max(self.iteration_s, 1e-12)

    @property
    def max_bubble_s(self) -> float:
        return max((d for k, d in self.segments if k == "bubble"), default=0.0)

    def as_training_profile(self, peak_memory_bytes: int) -> TrainingProfile:
        return TrainingProfile(
            name=self.name,
            peak_memory_bytes=peak_memory_bytes,
            iteration_time_s=self.iteration_s,
            max_bubble_s=self.max_bubble_s,
            bubble_fraction=self.bubble_fraction,
        )


# ---------------------------------------------------------------------------
# Segment-structure constructors
# ---------------------------------------------------------------------------


def dp_profile(
    name: str,
    compute_s: float,
    comm_s: float,
    overlap: float = 0.3,
    num_buckets: int = 2,
):
    """DP (DDP-style): backward interleaves per-bucket gradient all-reduces,
    so the exposed communication appears as a few mid-backward stalls plus a
    larger tail (last bucket + optimizer sync) — this is the multi-gap
    utilization trace of the paper's Fig. 1a."""
    exposed = comm_s * (1.0 - overlap)
    fwd = compute_s * 0.33
    bwd = compute_s * 0.67
    tail = exposed * 0.42
    fwd_gap = exposed * 0.04  # host-sync / input-pipeline hiccups in forward
    per_bucket_b = (exposed - tail - 2 * fwd_gap) / num_buckets
    per_bucket_c = bwd / num_buckets
    segs = [
        ("compute", fwd * 0.4),
        ("bubble", fwd_gap),
        ("compute", fwd * 0.6),
        ("bubble", fwd_gap),
    ]
    for _ in range(num_buckets):
        segs.append(("compute", per_bucket_c))
        segs.append(("bubble", per_bucket_b))
    segs.append(("bubble", tail))
    return IterationProfile(name, tuple(segs), "dp")


def mp_profile(name: str, compute_s: float, comm_s: float, num_layers: int):
    """MP/TP: per-layer compute followed by a short activation collective.
    2 collectives per layer fwd + 2 bwd (Megatron pairing)."""
    n = max(num_layers, 1)
    c, b = compute_s / n, comm_s / n
    segs = tuple(
        seg for _ in range(n) for seg in (("compute", c), ("bubble", b))
    )
    return IterationProfile(name, segs, "mp")


def pp_profile(
    name: str, compute_s: float, comm_s: float, num_microbatches: int = 12,
):
    """PP: warmup/drain bubbles at iteration boundaries (~35% of exposed
    idle) plus per-microbatch send gaps.  Dividing the mini-batch into
    microbatches shortens each gap to the edge of monitor detectability —
    the paper's stated reason SpecInF's PP gains are marginal (§5.2)."""
    m = max(num_microbatches, 1)
    warm = comm_s * 0.35
    per_mb_c = compute_s / m
    per_mb_b = comm_s * 0.65 / m
    segs = [("bubble", warm * 0.5)]
    for _ in range(m):
        segs.append(("compute", per_mb_c))
        segs.append(("bubble", per_mb_b))
    segs.append(("bubble", warm * 0.5))
    return IterationProfile(name, tuple(segs), "pp")


# ---------------------------------------------------------------------------
# Analytic estimation from model configs
# ---------------------------------------------------------------------------


def train_flops(cfg: ModelConfig, tokens: int) -> float:
    """6 * N_active * D."""
    return 6.0 * cfg.active_param_count() * tokens


def analytic_iteration(
    cfg: ModelConfig,
    *,
    seq_len: int,
    per_device_batch: int,
    num_devices: int,
    mode: str,
    hw: HardwareSpec,
    overlap: float = 0.3,
    target_bubble_fraction: float | None = None,
) -> IterationProfile:
    """``target_bubble_fraction``: calibrate exposed communication to a
    *measured* idle fraction (the paper's Fig. 1 traces: ~0.30 for DP, ~0.35
    for MP, ~0.15 for PP) instead of the idealized link-peak estimate —
    production all-reduces at DDP message sizes never reach link peak."""
    tokens = per_device_batch * seq_len
    compute_s = train_flops(cfg, tokens) / (hw.peak_flops * hw.mfu_assumption)
    p_bytes = cfg.param_count() * 2  # bf16 grads on the wire
    if target_bubble_fraction is not None:
        f = target_bubble_fraction
        exposed = compute_s * f / (1.0 - f)
        if mode == "dp":
            return dp_profile(cfg.name, compute_s, exposed, overlap=0.0)
        if mode == "mp":
            return mp_profile(cfg.name, compute_s, exposed, cfg.num_layers)
        if mode == "pp":
            return pp_profile(cfg.name, compute_s, exposed)
        raise ValueError(mode)
    if mode == "dp":
        # ring all-reduce: 2 * size * (n-1)/n per device
        comm_s = 2 * p_bytes * (num_devices - 1) / num_devices / hw.link_bandwidth
        return dp_profile(cfg.name, compute_s, comm_s, overlap)
    if mode == "mp":
        # Megatron TP: 4 all-reduces of [B, S, d] activations per layer
        act = per_device_batch * seq_len * cfg.d_model * 2
        per_ar = 2 * act * (num_devices - 1) / num_devices / hw.link_bandwidth
        comm_s = 4 * per_ar * cfg.num_layers
        return mp_profile(cfg.name, compute_s, comm_s, cfg.num_layers)
    if mode == "pp":
        act = per_device_batch * seq_len * cfg.d_model * 2
        comm_s = 2 * act / hw.link_bandwidth  # boundary sends fwd+bwd
        return pp_profile(cfg.name, compute_s, comm_s)
    raise ValueError(mode)


def analytic_inference_profile(
    cfg: ModelConfig,
    *,
    batch: int,
    seq_or_context: int,
    hw: HardwareSpec,
    kind: str = "decode",
    online: bool = False,
    name: str | None = None,
) -> InstanceProfile:
    """Memory + latency footprint of one inference microstep.

    decode: one token for ``batch`` slots against a ``seq_or_context`` cache —
    memory-bandwidth-bound (reads all active params + cache).
    batch_infer: one full forward at ``seq_or_context`` length (offline
    classification-style microstep; compute-bound).
    """
    p_bytes = cfg.active_param_count() * 2
    if kind == "decode":
        hd = cfg.resolved_head_dim
        cache_bytes = (
            cfg.num_layers * 2 * cfg.num_kv_heads * hd * seq_or_context * batch * 2
            if cfg.num_kv_heads
            else cfg.num_layers * cfg.d_inner * cfg.ssm_state * batch * 4
        )
        latency = (p_bytes + cache_bytes) / hw.hbm_bandwidth
        mem = p_bytes + cache_bytes
    else:
        tokens = batch * seq_or_context
        flops = 2.0 * cfg.active_param_count() * tokens
        latency = flops / (hw.peak_flops * hw.mfu_assumption)
        mem = p_bytes + tokens * cfg.d_model * 8  # activations
    return InstanceProfile(
        name=name or f"{cfg.name}-{kind}",
        peak_memory_bytes=int(mem),
        min_exec_time_s=float(latency),
        online=online,
    )


# -- CV inference workloads from the paper (ResNet152 / VGG19) enter as cost
#    profiles only; there is no CNN in the LM model zoo.
def cv_profile(name: str, hw: HardwareSpec, *, online: bool = False):
    GFLOPS = {"resnet152": 11.5e9, "vgg19": 19.6e9}
    MEM = {"resnet152": 0.9e9, "vgg19": 1.2e9}
    flops = GFLOPS[name] * 8  # batch 8 per microstep
    return InstanceProfile(
        name=name,
        peak_memory_bytes=int(MEM[name]),
        min_exec_time_s=flops / (hw.peak_flops * 0.25),  # CNNs reach lower MFU
        online=online,
    )


# ---------------------------------------------------------------------------
# A DP profile measured on the device
# ---------------------------------------------------------------------------


def measure_dp_profile(
    name: str,
    train_step: Callable[[Any, Any], tuple[Any, Any]],
    state: Any,
    batches: Iterator,
    engine: Any,
    *,
    probe_slots: int = 4,
) -> tuple[IterationProfile, float]:
    """A DP profile in the device's own units, and the engine's microstep.

    ``compute_s`` is the wall time of one ``train_step`` after a warm-up
    step (both steps train ``state``, which the step updates in place);
    ``comm_s = compute_s / 2``, the reference example's ratio.  The
    microstep is the wall time of one decode-only quantum of the largest
    fused size with ``probe_slots`` offline requests running, over its
    size, after one untimed quantum of that size (on CUDA it captures the
    quantum's graph).  The probe's requests run to their end and leave the
    engine's core empty.  Returns ``(profile, microstep_s)``."""
    device = engine.device
    for _ in range(2):
        t0 = time.monotonic()
        train_step(state, next(batches))
        synchronize(device)
    compute_s = time.monotonic() - t0

    core, k = engine.core, DECODE_K_BUCKETS[-1]
    if core.has_unfinished:
        raise ValueError("the microstep probe needs an engine with no requests")
    rng = np.random.default_rng(0)
    reqs = [core.submit(rng.integers(0, engine.cfg.vocab_size, 24).astype(np.int32),
                        SamplingParams(max_new_tokens=1 + 3 * k),
                        priority=Priority.OFFLINE)
            for _ in range(probe_slots)]
    core.step()  # admits and prefills every probe request
    core.step()  # the untimed quantum
    synchronize(device)
    t0 = time.monotonic()
    out = core.step()
    synchronize(device)
    secs = time.monotonic() - t0
    while core.has_unfinished:
        core.step()
    decoded = sum(len(o.new_tokens) for o in out.outputs)
    if out.k != k or out.prefill_tokens or decoded != k * probe_slots or any(
            len(r.output_tokens) != 1 + 3 * k for r in reqs):
        raise RuntimeError(
            f"microstep probe: quantum k={out.k}, prefill {out.prefill_tokens}, "
            f"{decoded} tokens decoded (expected k={k} over {probe_slots} slots)")
    return dp_profile(name, compute_s=compute_s, comm_s=compute_s / 2), secs / k
