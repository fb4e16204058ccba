"""SpecInF core: the paper's control plane over the port's trainer and
engine (counterpart of ``repro.core``).

  * BubbleMonitor            -- sliding-window idle detection (§3.3)
  * AdaptiveKernelScheduler  -- Algorithm 1 (conservative/incremental/stable)
  * plan_collocation         -- Principles I & II (§3.2)
  * IterationProfile         -- the training iteration's compute / bubble
                                segments (dp / mp / pp shapes; a dp one
                                measured on the device, or analytic over a
                                ``core.hardware.HardwareSpec``)
  * SpecInFRuntime           -- speculative filling over real compute
  * make_collocated_step     -- the fused train step + k decode microsteps
                                (``pick_bucket`` sizes k from a grant)
  * simulator / baselines    -- calibrated timeline evaluation vs MPS / TGS /
                                Co-Exec / Exclusive over ``core.queues``'
                                Poisson arrivals; import them from their
                                modules (the simulator's ``SpecInFPolicy`` is
                                not the runtime's, exported here)
"""
from repro_torch.core.bubble_monitor import BubbleMonitor
from repro_torch.core.collocation import (
    CollocationPlan,
    InstanceProfile,
    TrainingProfile,
    plan_collocation,
)
from repro_torch.core.filling import (
    FillingMetrics,
    SpecInFPolicy,
    SpecInFRuntime,
    make_collocated_step,
    pick_bucket,
)
from repro_torch.core.profiles import (
    IterationProfile,
    dp_profile,
    measure_dp_profile,
    mp_profile,
    pp_profile,
)
from repro_torch.core.scheduler import (
    AdaptiveKernelScheduler,
    Phase,
    ScheduleDecision,
    Status,
)

__all__ = [
    "AdaptiveKernelScheduler",
    "BubbleMonitor",
    "CollocationPlan",
    "FillingMetrics",
    "InstanceProfile",
    "IterationProfile",
    "Phase",
    "ScheduleDecision",
    "SpecInFPolicy",
    "SpecInFRuntime",
    "Status",
    "TrainingProfile",
    "dp_profile",
    "make_collocated_step",
    "measure_dp_profile",
    "mp_profile",
    "pick_bucket",
    "plan_collocation",
    "pp_profile",
]
