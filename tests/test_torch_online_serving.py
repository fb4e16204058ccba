"""The port's online-serving example (``examples/torch_online_serving.py``)
on the CPU at the smoke size.  The reference example cannot run here (it
goes through ``make_train_step``, ROADMAP C1), so the port's is held to its
own invariants: every Poisson ONLINE request served inside the bubbles,
finite losses, latencies on the virtual clock, Algorithm 1's phases
counted; ``run`` with no profile measures one on the device, as the card's
smoke runs it at full width; the default device raises without CUDA."""
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.configs import TrainConfig

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def example():
    spec = importlib.util.spec_from_file_location(
        "torch_online_serving", ROOT / "examples" / "torch_online_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_serves_every_online_request(example, capsys):
    m, requests = example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(requests) == 12 and m.online_served == 12
    assert all(r.finish_reason == "length" and len(r.output_tokens) == 4 for r in requests)
    assert m.train_iterations == 12 and all(math.isfinite(x) for x in m.train_losses)
    lat, ttft = m.p95_latency_s(), m.p95_ttft_s()
    assert 0 < ttft <= lat <= m.virtual_time_s
    assert sum(m.phase_counts.values()) > 0
    assert "online: served 12/12 requests" in out and "phases:" in out


def test_run_measures_a_profile_when_none_is_given(example):
    cfg = configs.smoke_config("olmo-1b")
    m, requests, profile, microstep_s = example.run(
        cfg, "cpu", tcfg=TrainConfig(learning_rate=1e-3), seq_len=16, global_batch=2,
        max_seq=64, iterations=2, num_requests=3)
    assert profile.compute_s > 0 and profile.bubble_s == pytest.approx(profile.compute_s / 2 * 0.7)
    assert microstep_s > 0 and len(requests) == 3
    assert m.train_iterations == 2 and all(math.isfinite(x) for x in m.train_losses)


def test_default_device_raises_without_cuda(example):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
