"""Baseline GPU-sharing policies (paper §5.1): MPS, TGS, Co-Exec, Exclusive
(own copy of ``repro.core.baselines``).

The implementations live in ``core.simulator`` (they share the timeline
contract with SpecInF); this module is the stable public surface.
"""
from repro_torch.core.simulator import (
    CoExecPolicy,
    ExclusivePolicy,
    MPSPolicy,
    Policy,
    SpecInFPolicy,
    TGSPolicy,
    make_policy,
)

ALL_POLICIES = ("specinf", "mps", "tgs", "co-exec", "exclusive")

__all__ = [
    "Policy",
    "SpecInFPolicy",
    "MPSPolicy",
    "TGSPolicy",
    "CoExecPolicy",
    "ExclusivePolicy",
    "make_policy",
    "ALL_POLICIES",
]
