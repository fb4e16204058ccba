"""The readings the limits of ``correct`` are set from: one cell run on
several seeds in one process, each run also computing the control (the
reference in float8 in the program's place) and, for a training cell, a
planted fault (half of each batch left out, in the reference in the
program's place).  One JSON line a seed, on standard output.

  python3 bench/calibrate.py --workload <cell> --seeds 101,102,103 --seconds 10
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    a = ap.parse_args(argv)
    import torch

    for seed in (int(s) for s in a.seeds.split(",")):
        args = run.parse(["--workload", a.workload, "--seed", str(seed),
                          "--seconds", str(a.seconds)])
        res = run.measure(args, calibrate=True)
        rec = res.pop("record")
        line = json.dumps({"seed": seed, "numbers": rec["numbers"], "correct": res["correct"],
                           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                           "memory_allocated": torch.cuda.memory_allocated()})
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
