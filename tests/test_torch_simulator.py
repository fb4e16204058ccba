"""The port's evaluation layer against the reference, on the CPU.

``repro_torch.core.simulator`` / ``baselines`` / ``queues`` / ``hardware``
and the analytic half of ``profiles`` are numpy copies of the reference's;
each runs beside its counterpart on the same inputs:

* (a) ``simulate`` under every policy, over the dp / mp / pp profiles of
  ``tests/test_simulator.py``, with one offline instance and with its
  saturating online queue over 3 instances (plus 4 offline instances,
  a busy hold and non-default calibrations): every ``SimResult`` field
  equal (``==``; NaN where both are NaN);
* (b) the paper's §5.2 orderings that ``tests/test_simulator.py`` asserts
  on the reference, asserted on the port;
* (c) the Poisson arrivals and the queue's priority-aware pull;
* (d) the analytic profiles for every arch on V5E, A100_40G and the H100
  (the reference's functions given a ``HardwareSpec`` with the H100's
  fields): segments and ``InstanceProfile`` fields equal;
* (e) the hardware constants, and the simulator's ``SpecInFPolicy`` kept
  apart from the runtime's.
"""
import dataclasses
import math

import pytest

from repro import configs as jconfigs
from repro.configs.base import SpecInFConfig as JSpecInFConfig
from repro.core import hardware as jhw
from repro.core import profiles as jprof
from repro.core import queues as jq
from repro.core import simulator as jsim
from repro_torch import configs as tconfigs
from repro_torch import core as tcore
from repro_torch.configs.base import SpecInFConfig as TSpecInFConfig
from repro_torch.core import baselines as tbase
from repro_torch.core import filling as tfilling
from repro_torch.core import hardware as thw
from repro_torch.core import profiles as tprof
from repro_torch.core import queues as tq
from repro_torch.core import simulator as tsim

POLICIES = tbase.ALL_POLICIES
PROFILE_ARGS = {
    "dp": ("dp_profile", ("dp", 0.9, 0.6), {"overlap": 0.0}),
    "mp": ("mp_profile", ("mp", 1.0, 0.5, 12), {}),
    "pp": ("pp_profile", ("pp", 0.8, 0.15), {}),
}
#: the saturating online load of ``tests/test_simulator.py``'s p95 test
ONLINE = dict(mean_interval_s=0.040, num_requests=600, service_s=0.020, seed=0)
CUSTOM_CAL = dict(kappa_train=0.2, kappa_inf=10.0, mps_inf_share=0.25,
                  multi_instance_drag=0.1, kernel_queue_delay_s=0.01,
                  tgs_probe_interval_s=0.05, tgs_busy_threshold=0.7, tick_s=0.001)


def _profile(mod, mode):
    fn, args, kw = PROFILE_ARGS[mode]
    return getattr(mod, fn)(*args, **kw)


def _sim(pkg, policy, mode, *, load, duration=10.0, cal=None, spec_kw=None):
    """One ``simulate`` run of package ``pkg`` ("j" or "t")."""
    prof, q, sim, cfg_cls = ((jprof, jq, jsim, JSpecInFConfig) if pkg == "j"
                             else (tprof, tq, tsim, TSpecInFConfig))
    spec = cfg_cls(**(spec_kw or {"busy_hold_ms": 0.0}))
    kw = dict(offline_instances=0)
    if load == "offline":
        kw = dict(offline_instances=1, offline_microstep_s=0.010)
    elif load == "offline4":
        kw = dict(offline_instances=4, offline_microstep_s=0.010)
    elif load == "online":
        kw = dict(online_queue=q.RequestQueue(q.poisson_arrivals(**ONLINE)),
                  online_instances=3)
    return sim.simulate(_profile(prof, mode), sim.make_policy(policy, spec),
                        duration_s=duration, cal=sim.Calibration(**(cal or {})),
                        specinf_cfg=spec, **kw)


def _fields(res):
    return {k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
            for k, v in dataclasses.asdict(res).items()}


def _assert_same(**kw):
    ref, ours = _sim("j", **kw), _sim("t", **kw)
    assert _fields(ours) == _fields(ref)
    return ours


# ---------------------------------------------------------------------------
# (a) simulator parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("load", ["offline", "online"])
@pytest.mark.parametrize("mode", ["dp", "mp", "pp"])
@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_equals_reference(policy, mode, load):
    res = _assert_same(policy=policy, mode=mode, load=load)
    if load == "online":
        # PP's per-microbatch gaps (~8 ms) fit no 20 ms service: SpecInF's
        # profile-informed gate never pulls there (the paper's PP finding)
        assert (res.online_served == 0) == (policy == "specinf" and mode == "pp")


def test_specinf_four_offline_instances_equal_reference():
    res = _assert_same(policy="specinf", mode="dp", load="offline4")
    assert res.offline_completed > 0


def test_specinf_busy_hold_equals_reference():
    """A 5 ms hold after each online pull (the config the online example
    runs): the cooldown path of the pull loop."""
    _assert_same(policy="specinf", mode="mp", load="online",
                 spec_kw={"busy_hold_ms": 5.0})


@pytest.mark.parametrize("policy", POLICIES)
def test_custom_calibration_equals_reference(policy):
    _assert_same(policy=policy, mode="dp", load="online", cal=CUSTOM_CAL)


def test_exclusive_training_equals_reference():
    runs = []
    for prof, sim, cfg_cls in ((jprof, jsim, JSpecInFConfig), (tprof, tsim, TSpecInFConfig)):
        runs.append(_fields(sim.simulate(
            _profile(prof, "pp"), sim.make_policy("mps"), duration_s=5.0,
            offline_instances=2, exclusive_training=True, specinf_cfg=cfg_cls())))
    assert runs[0] == runs[1] and runs[1]["offline_completed"] == 0


# ---------------------------------------------------------------------------
# (b) the paper's §5.2 orderings on the port (tests/test_simulator.py's)
# ---------------------------------------------------------------------------

TPROFILES = {mode: _profile(tprof, mode) for mode in PROFILE_ARGS}
TSPEC = TSpecInFConfig(busy_hold_ms=0.0)


def _run(policy, mode, *, offline=1, online_q=None, online_instances=0):
    return tsim.simulate(TPROFILES[mode], tsim.make_policy(policy, TSPEC), duration_s=30.0,
                         offline_instances=offline, offline_microstep_s=0.010,
                         online_queue=online_q, online_instances=online_instances,
                         cal=tsim.Calibration(), specinf_cfg=TSPEC)


@pytest.mark.parametrize("mode", ["dp", "mp", "pp"])
def test_port_specinf_preserves_training_throughput(mode):
    assert _run("specinf", mode).train_throughput_norm >= 0.93


@pytest.mark.parametrize("mode", ["dp", "mp"])
def test_port_coexec_hurts_training(mode):
    assert (_run("co-exec", mode).train_throughput_norm
            < _run("specinf", mode).train_throughput_norm)


@pytest.mark.parametrize("mode", ["dp", "mp", "pp"])
def test_port_specinf_beats_tgs_and_mps_offline(mode):
    spec = _run("specinf", mode).offline_throughput_per_s
    assert spec > _run("tgs", mode).offline_throughput_per_s
    if mode != "pp":
        assert spec > _run("mps", mode).offline_throughput_per_s


def test_port_exclusive_normalises_and_bounds_specinf():
    assert _run("exclusive", "dp").offline_norm == pytest.approx(1.0, rel=0.05)
    assert 0.15 <= _run("specinf", "dp").offline_norm <= 1.0


@pytest.mark.parametrize("mode", ["dp", "mp"])
def test_port_specinf_online_p95_beats_coexec_and_mps(mode):
    p95 = {pol: _run(pol, mode, offline=0, online_instances=3,
                     online_q=tq.RequestQueue(tq.poisson_arrivals(**ONLINE))).online_p95_s
           for pol in ("specinf", "co-exec", "mps")}
    assert p95["specinf"] < p95["co-exec"] and p95["specinf"] < p95["mps"]


def test_port_multi_instance_sublinear_scaling():
    prev = 0.0
    by_m = {}
    for m in (1, 2, 4):
        r = _run("specinf", "dp", offline=m)
        assert r.offline_throughput_per_s >= prev * 0.98
        assert r.train_throughput_norm >= 0.90
        prev = by_m[m] = r.offline_throughput_per_s
    assert by_m[4] < 4 * by_m[1]


def test_port_monitor_overhead_is_small():
    base = _run("exclusive", "dp", offline=0)
    idle = _run("specinf", "dp", offline=0)
    assert 1.0 - idle.train_iterations / base.train_iterations <= 0.02


def test_port_pp_gains_are_marginal():
    def gain(mode):
        return (_run("specinf", mode).offline_throughput_per_s
                / max(_run("mps", mode).offline_throughput_per_s, 1e-9))

    pp = gain("pp")
    assert pp < gain("dp") and pp < 2.0


# ---------------------------------------------------------------------------
# (c) queues
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_poisson_arrivals_equal_reference(seed):
    kw = dict(mean_interval_s=0.05, num_requests=64, service_s=0.02, seed=seed,
              online=seed % 2 == 0, start_s=0.5 * seed)
    assert ([dataclasses.asdict(r) for r in tq.poisson_arrivals(**kw)]
            == [dataclasses.asdict(r) for r in jq.poisson_arrivals(**kw)])


def test_queue_pull_order_and_latencies_equal_reference():
    """Online first, FIFO within a class; p95 / mean over one shared list
    of finished requests."""
    spec = [(0.0, False), (0.1, False), (0.2, True), (0.05, True), (0.3, False), (0.25, True)]
    logs = []
    for q in (jq, tq):
        reqs = [q.SimRequest(arrival_s=a, service_s=0.1, request_id=i, online=o)
                for i, (a, o) in enumerate(spec)]
        queue = q.RequestQueue(reqs)
        order, avail = [], []
        for now in (0.0, 0.06, 0.22, 0.22, 0.26, 0.4, 0.4, 0.4):
            avail.append(queue.available(now))
            r = queue.pull(now)
            if r is not None:
                r.start_s, r.finish_s = now, now + 0.1 * (1 + r.request_id)
                queue.done(r)
                order.append(r.request_id)
        logs.append((order, avail, queue.remaining, queue.p95_latency(), queue.mean_latency()))
    assert logs[0] == logs[1]
    assert logs[1][0] == [0, 3, 2, 1, 5, 4]
    empty = tq.RequestQueue([])
    assert math.isnan(empty.p95_latency()) and math.isnan(empty.mean_latency())


# ---------------------------------------------------------------------------
# (d) analytic profiles, every arch
# ---------------------------------------------------------------------------

HWS = {
    "v5e": (jhw.V5E, thw.V5E),
    "a100": (jhw.A100_40G, thw.A100_40G),
    "h100": (jhw.HardwareSpec(**dataclasses.asdict(thw.H100)), thw.H100),
}


def _analytic(prof, cfg, hw):
    out = {"flops": prof.train_flops(cfg, 4096)}
    for mode in ("dp", "mp", "pp"):
        for f in (None, 0.3):
            it = prof.analytic_iteration(cfg, seq_len=1024, per_device_batch=4, num_devices=8,
                                         mode=mode, hw=hw, target_bubble_fraction=f)
            out[(mode, f)] = (it.name, it.segments, it.mode)
    for kind in ("decode", "batch_infer"):
        out[kind] = dataclasses.asdict(prof.analytic_inference_profile(
            cfg, batch=4, seq_or_context=512, hw=hw, kind=kind, online=kind == "decode"))
    for name in ("resnet152", "vgg19"):
        out[name] = dataclasses.asdict(prof.cv_profile(name, hw, online=True))
    return out


@pytest.mark.parametrize("hw", list(HWS))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_analytic_profiles_equal_reference(arch, hw):
    jh, th = HWS[hw]
    assert (_analytic(tprof, tconfigs.get_config(arch), th)
            == _analytic(jprof, jconfigs.get_config(arch), jh))


def test_analytic_iteration_rejects_unknown_mode():
    cfg = tconfigs.smoke_config("qwen3-1.7b")
    for f in (None, 0.3):
        with pytest.raises(ValueError):
            tprof.analytic_iteration(cfg, seq_len=64, per_device_batch=1, num_devices=2,
                                     mode="ep", hw=thw.H100, target_bubble_fraction=f)


# ---------------------------------------------------------------------------
# (e) hardware, and the name clash
# ---------------------------------------------------------------------------


def test_hardware_specs():
    assert dataclasses.asdict(thw.V5E) == dataclasses.asdict(jhw.V5E)
    assert dataclasses.asdict(thw.A100_40G) == dataclasses.asdict(jhw.A100_40G)
    assert dataclasses.asdict(thw.H100) == dict(
        name="h100-sxm", peak_flops=989e12, hbm_bandwidth=3.35e12, link_bandwidth=450e9,
        hbm_bytes=80 * 10**9, mfu_assumption=0.4)
    assert thw.H100.hbm_bytes == TSpecInFConfig().hbm_limit_bytes


def test_simulator_policy_does_not_shadow_the_runtime_policy():
    assert tcore.SpecInFPolicy is tfilling.SpecInFPolicy
    assert tbase.SpecInFPolicy is tsim.SpecInFPolicy
    assert tsim.SpecInFPolicy is not tfilling.SpecInFPolicy
    assert tbase.ALL_POLICIES == ("specinf", "mps", "tgs", "co-exec", "exclusive")
    assert [tsim.make_policy(p).name for p in tbase.ALL_POLICIES] == list(tbase.ALL_POLICIES)
    assert tsim.make_policy("coexec").name == "co-exec"
    with pytest.raises(ValueError):
        tsim.make_policy("fifo")
