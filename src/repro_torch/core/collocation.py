"""Collocation planner — Principles I & II (paper §3.2); own copy of
``repro.core.collocation``.

Principle-I: sum of peak memory of all collocated instances must stay below
the device HBM limit; pack as many inference instances as fit.
Principle-II: the minimal execution time (batch size 1) of a collocated
*online* inference must be shorter than the maximal training bubble, so at
least one request can be served per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.configs.base import SpecInFConfig


@dataclasses.dataclass(frozen=True)
class InstanceProfile:
    """Profiled footprint of one workload instance on one accelerator."""

    name: str
    peak_memory_bytes: int
    min_exec_time_s: float = 0.0  # batch-size-1 latency (inference)
    online: bool = False


@dataclasses.dataclass(frozen=True)
class TrainingProfile:
    name: str
    peak_memory_bytes: int
    iteration_time_s: float
    max_bubble_s: float  # longest contiguous idle window per iteration
    bubble_fraction: float = 0.0


@dataclasses.dataclass
class CollocationPlan:
    training: TrainingProfile
    accepted: list[InstanceProfile]
    rejected: list[tuple[InstanceProfile, str]]

    @property
    def num_instances(self) -> int:
        return len(self.accepted)

    @property
    def total_memory_bytes(self) -> int:
        return self.training.peak_memory_bytes + sum(
            i.peak_memory_bytes for i in self.accepted
        )


def plan_collocation(
    training: TrainingProfile,
    candidates: Sequence[InstanceProfile],
    cfg: SpecInFConfig,
) -> CollocationPlan:
    """Greedy packing under Principle-I, gating online work by Principle-II."""
    budget = cfg.hbm_limit_bytes - training.peak_memory_bytes
    if budget < 0:
        raise ValueError(
            f"training instance alone exceeds HBM: {training.peak_memory_bytes}"
            f" > {cfg.hbm_limit_bytes}"
        )
    accepted: list[InstanceProfile] = []
    rejected: list[tuple[InstanceProfile, str]] = []
    for cand in candidates:
        if len(accepted) >= cfg.max_instances:
            rejected.append((cand, "max_instances reached"))
            continue
        if cand.peak_memory_bytes > budget:
            rejected.append(
                (cand, f"Principle-I: needs {cand.peak_memory_bytes}, {budget} left")
            )
            continue
        if cand.online and cand.min_exec_time_s >= training.max_bubble_s:
            rejected.append(
                (
                    cand,
                    "Principle-II: min exec "
                    f"{cand.min_exec_time_s * 1e3:.1f}ms >= max bubble "
                    f"{training.max_bubble_s * 1e3:.1f}ms",
                )
            )
            continue
        accepted.append(cand)
        budget -= cand.peak_memory_bytes
    return CollocationPlan(training, accepted, rejected)
