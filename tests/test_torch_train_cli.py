"""The port's training CLI (``repro_torch.launch.train``) and quickstart
example (``examples/torch_quickstart.py``), on the CPU at the smoke size.

* A run with ``--ckpt-dir`` checkpoints; a second run on the same
  directory prints ``resumed from step N`` and trains on from there.
* ``--collocate`` runs the trainer's step under ``SpecInFRuntime``: the
  microstep probe runs, the train steps finish and the engine produces
  offline tokens in the bubbles (the profile the runtime sees is fixed at
  the reference CLI's 50 / 25 / 4 ms, so the grants do not depend on the
  machine's load).
* ``--production-mesh`` raises unless the process group has 256 ranks;
  without a CUDA device the default device raises.
* The quickstart trains a few steps and streams a greedy decode.
"""
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch import core
from repro_torch.core import dp_profile
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--smoke", "--device", "cpu", "--seq-len", "16", "--global-batch", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops gain nothing from intra-op threads, and under the
    parallel test run every worker's threads would compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_checkpoints_then_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    report = train.main(SMOKE + ["--steps", "2", "--ckpt-dir", ckpt, "--ckpt-every", "1"])
    first = capsys.readouterr().out
    assert report.steps == 2 and all(math.isfinite(x) for x in report.losses)
    assert "resumed" not in first and "[train] 2 steps" in first
    assert "checkpoints=3" in first  # steps 1 and 2, and the final save
    report = train.main(SMOKE + ["--steps", "1", "--ckpt-dir", ckpt])
    second = capsys.readouterr().out
    assert "[train] resumed from step 2" in second
    assert report.steps == 1 and report.restores == 1


def test_cli_collocate_fills_bubbles(capsys, monkeypatch):
    # the probe runs, but its wall-clock times vary with the machine's load:
    # a microstep over Algorithm 1's 64 ms cap would leave every bubble
    # empty, so the profile the runtime sees is fixed (virtual clock)
    probes = []

    def fixed_profile(name, step, state, batches, engine):
        probes.append(measure(name, step, state, batches, engine))
        return dp_profile(name, compute_s=0.05, comm_s=0.025), 0.004

    measure = core.measure_dp_profile
    monkeypatch.setattr(core, "measure_dp_profile", fixed_profile)
    metrics = train.main(["--smoke", "--device", "cpu", "--global-batch", "2",
                          "--steps", "3", "--collocate"])
    out = capsys.readouterr().out
    assert len(probes) == 1 and probes[0][1] > 0
    assert metrics.train_iterations == 3
    assert all(math.isfinite(x) for x in metrics.train_losses)
    assert metrics.offline_tokens_generated > 0
    assert "[train+fill] 3 train steps" in out


def test_cli_refuses_what_is_not_ported():
    # the 16x16 mesh needs 256 ranks; this process is one
    with pytest.raises(ValueError, match="needs 256 ranks"):
        train.main(SMOKE + ["--production-mesh"])
    assert not torch.distributed.is_initialized()  # the CLI's own group is gone
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--smoke", "--steps", "1"])


def test_quickstart_example_runs(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--steps", "3"])
    printed = capsys.readouterr().out
    assert len(out) == 9 and "generated:" in printed and "step   2 loss" in printed
