"""The metric readers on hand-made records, and the trace reduction on a
hand-made profile."""
import importlib.util
import json
import types
from pathlib import Path

import pytest
import torch

from costs import kernels as K
from harness import readers, trace

BENCH = Path(__file__).resolve().parents[1]
CFG = json.loads((BENCH / "configs" / "olmo-1b.json").read_text())


def metric(name, rec):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def fill_record(**kw):
    r = {"window_s": 10.0, "iterations": [0.4] * 20, "train_ms": [300.0] * 20,
         "tokens_per_step": 4096, "bubble_s": 0.1, "microstep_s": 0.007, "offline_tokens": 2000,
         "offline_microsteps": 200, "model": CFG["model"], "config": CFG, "trace": None,
         "setup_s": 30.0}
    r.update(kw)
    return r


def test_fill_readers():
    r = fill_record()
    assert metric("train_tokens_per_s", r) == pytest.approx(20 * 4096 / 10)
    assert metric("offline_tokens_per_s", r) == pytest.approx(200)
    assert metric("fill_over_bubble_pct.fill", r) == pytest.approx(100.0)
    assert metric("bubble_filled_pct.fill", r) == pytest.approx(100 * 200 * 0.007 / 2.0)
    assert metric("train_step_ms.fill", r) == pytest.approx(300.0)
    assert metric("fill_tokens_per_s.fill", r) == pytest.approx(2000 / 2.0)
    assert metric("setup_s", r) == 30.0
    assert 0 < metric("mfu.train", r) < 100
    for name in ("flash_roofline.train", "device_idle_pct.fill"):
        assert metric(name, r) is None  # no trace: nothing to read
    for name in ("fill_over_bubble_pct.fill", "fill_tokens_per_s.fill", "bubble_filled_pct.fill"):
        assert metric(name, fill_record(iterations=[])) is None


def test_tails_count_every_request():
    due = [float(i) for i in range(100)]
    online = [(d, d + 0.01 * (i + 1), d + 0.02 * (i + 1)) for i, d in enumerate(due)]
    r = {"online": online}
    assert metric("online_latency_p95_ms", r) == pytest.approx(1900.0)
    assert readers.p95([1.0] * 19 + [float("inf")]) == 1.0
    assert readers.p95([1.0] * 18 + [float("inf")] * 2) == float("inf")


def step(t0, t1, k, prefill=0, decoding=(), admitted=(), traced=0):
    return {"t0": t0, "t1": t1, "k": k, "prefill_tokens": prefill, "tokens": 0,
            "decoding": list(decoding), "admitted": list(admitted), "skipped": 0,
            "traced": traced}


def test_engine_readers():
    steps = [step(0.0, 0.04, 8, decoding=[(100, 50), (10, 3)]),
             step(0.04, 0.06, 1, prefill=70, decoding=[(5, 9)], admitted=[70]),
             # under the profiler after the window: in no host-clock reading
             step(0.06, 1.06, 8, decoding=[(100, 50)], traced=1),
             step(1.06, 2.06, 1, prefill=70, decoding=[(5, 9)], admitted=[70], traced=2)]
    r = {"steps": steps, "engine_tokens": 30, "engine_steps": 3, "model": CFG["model"],
         "config": CFG, "trace": None, "offline_tokens": 600, "window_s": 0.06}
    assert metric("engine_step_ms.serve", r) == pytest.approx(30.0)
    assert metric("decode_microstep_ms.serve", r) == pytest.approx(5.0)
    assert metric("tokens_per_engine_step.serve", r) == pytest.approx(10.0)
    assert metric("offline_tokens_per_s.serve", r) == pytest.approx(10000.0)
    assert 0 < metric("mfu.decode", r) < 100
    assert 0 < metric("mfu.prefill_step", r) < 100
    assert readers.decode_lengths(steps[0])[:4] == [[100, 10], [101, 11], [102, 12], [103]]
    assert readers.prefill_waves(steps[1], 32) == [[(0, 32)], [(32, 32)], [(64, 6)]]


def fake_profile(events):
    ev = [types.SimpleNamespace(name=n, device_type=d,
                                time_range=types.SimpleNamespace(start=a, end=b))
          for n, d, a, b in events]
    t = trace.Tracer(True)
    prof = types.SimpleNamespace(events=lambda: ev)
    # a millisecond of each stretch: the device's, then the one with spans
    t.stretches = [(prof, 0.0, 0.001), (prof, 0.0, 0.002)]
    return t.summary()


def test_trace_summary_and_rooflines():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    s = fake_profile([
        ("engine_step", cpu, 0, 900), ("engine_step", cuda, 0, 900),  # a span, twice
        ("paged_decode_cluster_kernel<bf16>", cuda, 100, 300),
        ("paged_decode_cluster_kernel<bf16>", cuda, 250, 400),
        ("nvjet_gemm", cuda, 600, 700),
    ])
    assert s["busy_s"] == pytest.approx(400e-6)
    assert s["kernels"]["paged_decode_cluster_kernel<bf16>"] == [pytest.approx(350e-6), 2]
    assert "engine_step" not in s["kernels"]
    assert s["idle"]["engine_step"] == pytest.approx(200e-6)
    assert s["idle"]["harness"] == pytest.approx(2e-3 - 600e-6)
    assert s["window_s"] == pytest.approx(1e-3) and s["idle_window_s"] == pytest.approx(2e-3)
    # the device trace is stretch 1's: the window's steps (0) and the spans
    # stretch's (2) add nothing to the bound
    r = {"trace": s, "steps": [step(0, 1, 1, decoding=[(100, 5)] * 8, traced=1),
                               step(1, 2, 1, decoding=[(100, 5)] * 8),
                               step(3, 4, 1, decoding=[(100, 5)] * 8, traced=2)],
         "model": CFG["model"], "config": CFG}
    assert metric("device_idle_pct.serve", r) == pytest.approx(60.0)
    b, h, kvh, hd, cols, _ = readers.engine_shape(r)
    one = K.bound_s(*K.paged_decode(b, h, kvh, hd, [100] * 8, cols)) * CFG["model"]["num_layers"]
    assert metric("paged_decode_roofline.serve", r) == pytest.approx(100 * one / 350e-6)
    assert metric("paged_prefill_roofline.serve", r) is None
    br = trace.breakdown(s)
    assert br["device_ops"][0][0].startswith("paged_decode") and len(br["idle_gaps"]) == 2
