"""Port SpecInF runtime against the reference, on the CPU in fp32.

``repro_torch.core.SpecInFRuntime`` and ``repro.core.SpecInFRuntime`` get
the same profile, weights, offline backlog and online arrivals, each with
its own package's engine (fp32) and train step (the port's
``make_train_step``; for the reference the same composition of
``repro.optim`` jitted around its loss).  Over 3 iterations the Algorithm-1
phase counts, offline microsteps, offline / online token counts, every
request's token stream and the virtual clock must be equal, and the losses
agree within 1e-5 relative (fp32, sums in another order).  The control
plane's pieces (monitor, Algorithm 1, collocation planner, profiles) are
held to the reference one by one, and the observability hooks the runtime
uses are checked.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import core as jcore
from repro.configs.base import SpecInFConfig as JSpecInFConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import profiles as jprofiles
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.models import transformer as JT
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro.optim import make_schedule as jmake_schedule
from repro.serving import core as jserving
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import configs
from repro_torch import core as tcore
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SpecInFConfig, TrainConfig
from repro_torch.data import SyntheticDataset
from repro_torch.obs import Observability
from repro_torch.obs.metrics import StreamingHistogram
from repro_torch.runtime import init_train_state, make_train_step
from repro_torch.serving import core as tserving
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.engine import Request as TRequest

ARCH = "qwen3-1.7b"
JCFG, CFG = jconfigs.smoke_config(ARCH), configs.smoke_config(ARCH)
NP_PARAMS = jax.tree.map(np.array, JT.init_params(JCFG, jax.random.PRNGKey(0)))
TRAIN_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20,
                compute_dtype="float32")
SEQ, BATCH, ITERS = 16, 2, 3
MICROSTEP_S = 0.004


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_train(jtcfg):
    sched = jmake_schedule(jtcfg)

    @jax.jit
    def step(state, batch):
        def loss_fn(p):
            return JT.lm_loss(JCFG, p, batch["inputs"], batch["labels"],
                              impl="xla", compute_dtype=jnp.float32)

        (loss, m), g = jax.value_and_grad(loss_fn, has_aux=True)(state["params"])
        g, gnorm = jclip(jax.tree.map(lambda x: x.astype(jnp.float32), g),
                         jtcfg.grad_clip_norm)
        new_p, new_opt = jadamw_update(g, state["opt"], state["params"],
                                       lr=sched(state["opt"]["step"]), cfg=jtcfg)
        return {"params": new_p, "opt": new_opt}, {"loss": loss, "grad_norm": gnorm}

    params = jax.tree.map(jnp.asarray, NP_PARAMS)
    ds = JDataset(JCFG, seq_len=SEQ, global_batch=BATCH, seed=1)
    batches = ({k: jnp.asarray(v) for k, v in ds.next_batch().items()}
               for _ in iter(int, 1))
    return step, {"params": params, "opt": jadamw_init(params)}, batches


def _torch_train():
    step = make_train_step(CFG, TrainConfig(**TRAIN_KW), device="cpu")
    state = init_train_state(params_from_numpy(NP_PARAMS, device="cpu"))
    ds = SyntheticDataset(CFG, seq_len=SEQ, global_batch=BATCH, seed=1)
    return step, state, (ds.next_batch() for _ in iter(int, 1))


def _prompts():
    rng = np.random.default_rng(3)
    offline = [rng.integers(0, CFG.vocab_size, n).astype(np.int32) for n in (8, 40)]
    online = [(rng.integers(0, CFG.vocab_size, n).astype(np.int32), 0.02 * i)
              for i, n in enumerate((5, 12, 33))]
    return offline, online


def _run(pkg):
    """The same collocated run with either package; returns what the
    comparison reads."""
    offline, online = _prompts()
    if pkg == "jax":
        step, state, batches = _jax_train(JTrainConfig(**TRAIN_KW))
        engine = JEngine(JCFG, jax.tree.map(jnp.asarray, NP_PARAMS), max_slots=3,
                         max_seq=64, compute_dtype=jnp.float32)
        serving, core, Request = jserving, jcore, JRequest
        profile = jprofiles.dp_profile("tiny", compute_s=0.05, comm_s=0.04)
        cfg = JSpecInFConfig()
    else:
        step, state, batches = _torch_train()
        engine = TEngine(CFG, params_from_numpy(NP_PARAMS, device="cpu"), max_slots=3,
                         max_seq=64, compute_dtype=torch.float32, device="cpu")
        serving, core, Request = tserving, tcore, TRequest
        profile = tcore.dp_profile("tiny", compute_s=0.05, comm_s=0.04)
        cfg = SpecInFConfig()
    for p in offline:
        engine.core.submit(p, serving.SamplingParams(max_new_tokens=20),
                           priority=serving.Priority.OFFLINE)
    reqs = [Request(prompt=p, max_new_tokens=4, arrival_time=t, online=True)
            for p, t in online]
    rt = core.SpecInFRuntime(
        train_step=step, train_state=state, batch_iter=batches, profile=profile,
        engine=engine, online_requests=reqs, cfg=cfg,
        decode_microstep_s=MICROSTEP_S,
    )
    m = rt.run(ITERS)
    streams = [
        (cr.priority.value, list(cr.output_tokens), cr.state.value)
        for _, cr in sorted(rt.core.requests.items())
    ]
    return {
        "losses": m.train_losses,
        "phases": dict(m.phase_counts),
        "offline_microsteps": m.offline_microsteps,
        "offline_tokens": m.offline_tokens_generated,
        "online_served": m.online_served,
        "preemptions": m.preemptions,
        "virtual_time_s": m.virtual_time_s,
        "ttft": sorted(m.online_ttft_s),
        "streams": streams,
    }


@pytest.fixture(scope="module")
def runs():
    return _run("jax"), _run("torch")


def test_runtime_phase_counts_and_filled_work_equal(runs):
    j, t = runs
    assert t["phases"] == j["phases"]
    assert set(t["phases"]) == {"conservative", "incremental", "stable"}
    for key in ("offline_microsteps", "offline_tokens", "online_served", "preemptions"):
        assert t[key] == j[key], key
    assert t["offline_tokens"] > 0 and t["online_served"] > 0
    assert t["virtual_time_s"] == pytest.approx(j["virtual_time_s"], rel=1e-12)


def test_runtime_token_streams_equal(runs):
    j, t = runs
    assert t["streams"] == j["streams"]
    assert t["ttft"] == pytest.approx(j["ttft"], rel=1e-9, abs=1e-12)


def test_runtime_losses_agree(runs):
    j, t = runs
    assert len(t["losses"]) == len(j["losses"]) == ITERS
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-5)


def test_engine_keeps_its_own_weights():
    """A collocated trainer updates its weights in place; the engine built
    on the same initial weights serves them unchanged (the reference's
    arrays are immutable): the train state owns a copy."""
    params = params_from_numpy(NP_PARAMS, device="cpu")
    engine = TEngine(CFG, params, max_slots=1, max_seq=32,
                     compute_dtype=torch.float32, device="cpu")
    before = {k: engine.params[k].clone() for k in ("embed", "final_norm")}
    ln1 = engine.params["layers"]["ln1"].clone()
    step, _, batches = _torch_train()
    state = init_train_state(params)
    for _ in range(2):  # the schedule's first lr is 0
        step(state, next(batches))
    assert not torch.equal(state["params"]["embed"], before["embed"])
    for k, v in before.items():
        assert torch.equal(engine.params[k], v) and torch.equal(params[k], v)
    assert torch.equal(engine.params["layers"]["ln1"], ln1)


def test_measured_dp_profile_leaves_the_engine_empty():
    """``measure_dp_profile``: the profile is dp-shaped over the measured
    step (comm = compute / 2), the microstep is positive, both calibration
    steps train, and the probe's requests have all finished."""
    step, state, batches = _torch_train()
    embed0 = state["params"]["embed"].clone()
    engine = TEngine(CFG, params_from_numpy(NP_PARAMS, device="cpu"), max_slots=4,
                     max_seq=64, compute_dtype=torch.float32, device="cpu")
    profile, microstep_s = tcore.measure_dp_profile("tiny", step, state, batches, engine)
    assert profile.mode == "dp" and profile.compute_s > 0 and microstep_s > 0
    ref = tcore.dp_profile("tiny", compute_s=profile.compute_s,
                           comm_s=profile.compute_s / 2)
    assert [k for k, _ in profile.segments] == [k for k, _ in ref.segments]
    assert [d for _, d in profile.segments] == pytest.approx([d for _, d in ref.segments])
    assert int(state["opt"]["step"]) == 2
    assert not torch.equal(state["params"]["embed"], embed0)
    assert not engine.core.has_unfinished
    # four probe requests of 1 + 3 k tokens: prefill, an untimed and a timed
    # k = 8 quantum, then the rest
    assert sum(len(r.output_tokens) for r in engine.core.requests.values()) == 4 * 25


# ---------------------------------------------------------------------------
# control-plane pieces against the reference
# ---------------------------------------------------------------------------

def test_engineless_runtime_matches_reference():
    def run(core, profiles, cfg):
        rt = core.SpecInFRuntime(
            train_step=lambda s, b: (s, {"loss": 1.0}), train_state=None,
            batch_iter=iter(int, 1), profile=profiles.mp_profile("mp", 0.04, 0.02, 4),
            cfg=cfg,
        )
        m = rt.run(2)
        return m.phase_counts, m.virtual_time_s, m.offline_tokens_generated

    assert run(tcore, tcore, SpecInFConfig()) == run(jcore, jprofiles, JSpecInFConfig())


def test_algorithm1_decisions_match_reference():
    rng = np.random.default_rng(0)
    zcs = rng.integers(0, 8, 200).tolist()
    kw = dict(alpha=2, beta=4, gamma=2.0, lower_limit=8.0, upper_limit=32.0)
    ts = tcore.AdaptiveKernelScheduler(SpecInFConfig(**kw), num_instances=2)
    js = jcore.AdaptiveKernelScheduler(JSpecInFConfig(**kw), num_instances=2)
    for zc in zcs:
        td, jd = ts.update(zc), js.update(zc)
        assert (td.tokens, td.status.value, td.phase.value) == (
            jd.tokens, jd.status.value, jd.phase.value)
    tm, jm = tcore.BubbleMonitor(SpecInFConfig()), jcore.BubbleMonitor(JSpecInFConfig())
    for a in rng.integers(0, 2, 100).tolist():
        assert tm.observe(a) == jm.observe(a)
    jstate = jm.state()
    assert jstate.pop("interrupts") == 0
    assert tm.state() == jstate


@pytest.mark.parametrize("mode", ["dp", "mp", "pp"])
def test_profiles_match_reference(mode):
    args = {"dp": (0.5, 0.25), "mp": (0.5, 0.25, 28), "pp": (0.5, 0.25, 6)}[mode]
    tp = getattr(tcore, f"{mode}_profile")("x", *args)
    jp = getattr(jprofiles, f"{mode}_profile")("x", *args)
    assert tp.segments == jp.segments and tp.mode == jp.mode
    assert tp.max_bubble_s == jp.max_bubble_s
    assert dataclasses.asdict(tp.as_training_profile(123)) == dataclasses.asdict(
        jp.as_training_profile(123))


def test_plan_collocation_matches_reference_under_a_common_budget():
    budget = dict(hbm_limit_bytes=16 * 1024**3, max_instances=3)
    plans = []
    for pkg, cfg_cls in ((tcore, SpecInFConfig), (jcore, JSpecInFConfig)):
        training = pkg.TrainingProfile("t", 9 * 1024**3, 0.1, max_bubble_s=0.02)
        cands = [
            pkg.InstanceProfile("a", 2 * 1024**3, 0.004, online=True),
            pkg.InstanceProfile("b", 6 * 1024**3, 0.001),
            pkg.InstanceProfile("c", 1 * 1024**3, 0.03, online=True),
            pkg.InstanceProfile("d", 1 * 1024**3),
            pkg.InstanceProfile("e", 1 * 1024**3),
            pkg.InstanceProfile("f", 1 * 1024**3),
        ]
        plan = pkg.plan_collocation(training, cands, cfg_cls(**budget))
        plans.append(([i.name for i in plan.accepted],
                      [(i.name, why) for i, why in plan.rejected],
                      plan.total_memory_bytes))
    assert plans[0] == plans[1]


def test_specinf_config_budgets_the_h100():
    cfg = SpecInFConfig()
    assert cfg.hbm_limit_bytes == 80 * 10**9
    assert cfg.hbm_limit_bytes != JSpecInFConfig().hbm_limit_bytes
    shared = {f.name for f in dataclasses.fields(SpecInFConfig)} - {"hbm_limit_bytes"}
    jdef = {f.name: f.default for f in dataclasses.fields(JSpecInFConfig)}
    assert {n: getattr(cfg, n) for n in shared} == {n: jdef[n] for n in shared}
    # the one deliberate difference: the H100's 80 GB against the v5e's 16 GiB
    assert set(jdef) - shared == {"hbm_limit_bytes"}


def test_busy_hold_ms_constructs_in_both_packages():
    ours, ref = SpecInFConfig(busy_hold_ms=5.0), JSpecInFConfig(busy_hold_ms=5.0)
    assert ours.busy_hold_ms == ref.busy_hold_ms == 5.0
    ours, ref = dataclasses.asdict(ours), dataclasses.asdict(ref)
    assert ours.pop("hbm_limit_bytes") != ref.pop("hbm_limit_bytes")
    assert ours == ref


# ---------------------------------------------------------------------------
# observability hooks the runtime reads
# ---------------------------------------------------------------------------

def test_histogram_values_and_collapse():
    h = StreamingHistogram("x")
    for x in (3.0, 1.0, 2.0):
        h.record(x)
    assert h.values() == [3.0, 1.0, 2.0]
    for x in range(StreamingHistogram.EXACT_CAP):
        h.record(float(x))
    with pytest.raises(RuntimeError, match="collapsed"):
        h.values()


def test_tracer_restamp_and_window_state_fold_into_quantum():
    engine = TEngine(CFG, params_from_numpy(NP_PARAMS, device="cpu"), max_slots=1,
                     max_seq=32, compute_dtype=torch.float32, device="cpu",
                     clock=lambda: 5.0)
    cr = engine.core.submit(np.arange(4), tserving.SamplingParams(max_new_tokens=2))
    tr = engine.obs.tracer
    tr.restamp_arrival(cr.request_id, 0.0)
    waiting = [ev for ev in tr.events if ev["type"] == "transition" and ev["to"] == "waiting"]
    assert [ev["t"] for ev in waiting] == [0.0]
    tr.window_state = {"zero_count": 4, "phase": "stable"}
    engine.core.step()
    engine.core.step()
    quanta = [ev for ev in tr.events if ev["type"] == "quantum"]
    assert quanta[0]["args"]["window"] == {"zero_count": 4, "phase": "stable"}
    assert quanta[1]["args"]["window"] is None and tr.window_state is None
    assert Observability(tracing=False).tracer.enabled is False
