"""The control of each cell, the plain reference in float8 put in the
program's place, must come out not correct under the cell's limits: here
at a CPU size, on the card at the cell's own size (``chip``)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import run
from harness import check
from test_bench_faults import BIG, tiny

CELLS = [w["name"] for w in json.loads((run.CHECKOUT / "BENCHMARK.json").read_text())["workloads"]]


def tiny_checked(ctx):
    """The CPU size, checking half as many served tokens as the cell does
    (a widest gap needs some hundreds of tokens to show)."""
    tiny(ctx)
    ctx.mix["check_tokens"] = 256


def control_verdict(numbers: dict, limits: dict) -> bool:
    ctl = {k: numbers["control_" + k] for k in limits if "control_" + k in numbers}
    return check.verdict(ctl, {k: limits[k] for k in ctl})[0]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_a_cpu_size(cell):
    for seed in (BIG, BIG + 1):
        args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "2"])
        res = run.measure(args, device=torch.device("cpu"), calibrate=True, adjust=tiny_checked)
        numbers = res["record"]["numbers"]
        assert numbers["served_tokens_checked"] > 0
        assert not control_verdict(numbers, run.load_json("workloads", cell + ".json")["limits"])


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seeds = "7000000001,7000000002,7000000003"
    p = subprocess.run([sys.executable, str(Path(run.BENCH) / "calibrate.py"), "--workload", cell,
                        "--seeds", seeds, "--seconds", "10"],
                       capture_output=True, text=True, timeout=1800, check=True)
    limits = run.load_json("workloads", cell + ".json")["limits"]
    for line in p.stdout.splitlines():
        numbers = json.loads(line)["numbers"]
        assert not control_verdict(numbers, limits), numbers
