"""``scripts/torch_dev_smoke.py`` (the port's counterpart of
``scripts/dev_smoke.py``) on the CPU: for a dense and a recurrent arch the
real parameter count equals the analytic one (the reference's
``param_count``, which ``tests/test_smoke_archs.py`` holds to the
reference's trees), the loss and the decode logits are finite, and the CLI
exits 0 printing one line an arch."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro import configs as jconfigs

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def dev_smoke():
    spec = importlib.util.spec_from_file_location("torch_dev_smoke",
                                                  ROOT / "scripts" / "torch_dev_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield mod
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b"])
def test_counts_and_decode(dev_smoke, arch):
    r = dev_smoke.smoke(arch, torch.device("cpu"))
    assert r["diff"] == 0
    assert r["real"] == r["analytic"] == jconfigs.smoke_config(arch).param_count()
    assert r["decode_ok"] and r["logits"] == (dev_smoke.BATCH, 256)


def test_cli(dev_smoke, capsys):
    assert dev_smoke.main(["--device", "cpu", "olmo-1b", "falcon-mamba-7b"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == ["olmo-1b", "falcon-mamba-7b"]
    assert all("diff=0 decode_ok=True" in ln for ln in lines)
    with pytest.raises(SystemExit):
        dev_smoke.main(["--device", "cpu", "gpt-5"])
