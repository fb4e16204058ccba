"""``bench/run.py`` as a benchmark run calls it, and ``BENCHMARK.json`` against
the files it names."""
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_run_exits_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for w in SPEC["workloads"]:
        p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", w["name"],
                            "--seed", "5000000001", "--seconds", "1", "--trace", "0"],
                           cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout.strip() == "", p.stderr


def test_every_name_has_its_file():
    for c in SPEC["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["source"].split()[0] == c["source"] and f["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        assert cell["limits"]
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{mix['driver']}.py").exists()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        mine = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layers = [m for m in SPEC["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layers
        for m in layers:
            moved = e2e[m["moves"]]
            assert w["name"] in moved.get("workloads", [w["name"]])
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline.serve") or "roofline" in m["name"]:
            assert any("mfu" in o["name"] and o["moves"] == m["moves"] for o in SPEC["per_layer"])
