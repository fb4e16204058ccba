"""The port's chaos-sweep script (``scripts/torch_check_chaos.py``) on the
CPU: the early-resume sweep whole, one serving seed and one recovery seed
per layout (the seed tuples narrowed), exit 1 when a check fails, and the
default device raising without CUDA.  The whole script (5 + 3 + 5 x 2
seeds) is run by hand: ``PYTHONPATH=src python scripts/torch_check_chaos.py
--device cpu``."""
import importlib.util
from pathlib import Path

import pytest
import torch

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
def chaos():
    spec = importlib.util.spec_from_file_location(
        "torch_check_chaos", ROOT / "scripts" / "torch_check_chaos.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_resume_sweep_passes(chaos, capsys):
    assert chaos.main(["--device", "cpu", "--only", "resume"]) == 0
    out = capsys.readouterr().out
    assert out.count("early_resumes=") == len(chaos.RESUME_SEEDS) and out.endswith("OK\n")


def test_one_serving_seed_passes(chaos, capsys, monkeypatch):
    monkeypatch.setattr(chaos, "SERVE_SEEDS", (5,))
    assert chaos.main(["--device", "cpu", "--only", "serve"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("seed=")]
    assert len(lines) == 1 and "clean=" in lines[0] and "attribution_residual" in lines[0]


def test_one_recovery_seed_per_layout_passes(chaos, capsys, monkeypatch):
    monkeypatch.setattr(chaos, "RECOVERY_SEEDS", (1,))
    assert chaos.main(["--device", "cpu", "--only", "recovery"]) == 0
    out = capsys.readouterr().out
    for layout in ("paged", "dense"):
        assert f"{layout} seed=1: kills=" in out and "finished=10/10" in out


def test_a_failed_check_exits_one(chaos, capsys, monkeypatch):
    monkeypatch.setattr(chaos, "SERVE_SEEDS", (1,))
    monkeypatch.setattr(chaos, "ATTRIBUTION_TOL", -1.0)  # no residual can meet it
    assert chaos.main(["--device", "cpu", "--only", "serve"]) == 1
    assert "FAIL: 1 chaos check(s) failed" in capsys.readouterr().out


def test_default_device_raises_without_cuda(chaos):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.main(["--only", "resume"])
