"""The benchmark of the PyTorch / CUDA port (``repro_torch``): one command,
one cell, one result line.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``bench/workloads/<cell>.json``) names a configuration
(``bench/configs/``) and a traffic mix (``bench/traffic/``); the mix names
the driver (``bench/drivers/<driver>.py``) that sets the program up, warms
it up, measures for ``--seconds`` and checks its outputs against the plain
reference (``bench/reference/``).  The metrics are those ``BENCHMARK.json``
lists for the cell (its ``end_to_end`` ones with ``--trace 0``, its
``per_layer`` ones with ``--trace 1``), each read by
``bench/metrics/<metric>.py`` from what the driver recorded.  The last line
of standard output is the result as one JSON object; the numbers compared
for ``correct`` end standard error.  Without enough CUDA devices it exits
with code 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
sys.path[:0] = [str(BENCH), str(CHECKOUT / "src")]

#: top-level module names that may not be loaded in the process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(*parts) -> dict:
    return json.loads(BENCH.joinpath(*parts).read_text())


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_names(bench: dict, cell: str, trace: bool) -> list:
    """The cell's metrics for this kind of run: those listing it, or those
    with no list (every cell)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [(m["name"], m["unit"]) for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


class Context:
    """What a driver is given: the cell's files, the run's arguments, the
    device, the tracer and a logger to standard error."""

    def __init__(self, args, cell: dict, device, tracer, calibrate: bool = False):
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.config = load_json("configs", cell["config"] + ".json")
        self.mix = load_json("traffic", cell["traffic"] + ".json")
        self.limits = cell["limits"]
        self.device, self.tracer, self.calibrate = device, tracer, calibrate
        self.window_start = None

    @staticmethod
    def log(msg: str) -> None:
        print(f"bench: {msg}", file=sys.stderr, flush=True)

    def mark(self, what: str) -> None:
        """Log how far into the process a stage ended."""
        self.log(f"{time.perf_counter() - T_START:9.3f} s  {what}")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(args, *, device=None, calibrate: bool = False, adjust=None) -> dict:
    """Run one cell and return the result object (``correct`` ... ``checks``)
    with the driver's record under ``"record"``.  ``device`` None means the
    card, checked first; tests pass the CPU and an ``adjust(ctx)`` that
    shrinks the cell.  ``calibrate`` also reads the control's numbers."""
    import torch

    from harness import check, gpu, trace

    cell = load_json("workloads", args.workload + ".json")
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    if (entry["config"], entry["traffic"]) != (cell["config"], cell["traffic"]):
        raise SystemExit(f"bench: {args.workload}: BENCHMARK.json and its cell file disagree")
    if device is None:
        gpu.require(entry["chips"])
        gpu.keep_caches_in(CHECKOUT)
        device = torch.device("cuda")
        Context.log(f"card: {gpu.card()}")
    tracer = trace.Tracer(bool(args.trace) and device.type == "cuda")
    ctx = Context(args, cell, device, tracer, calibrate)
    if adjust is not None:
        adjust(ctx)
    driver = load_module(BENCH / "drivers" / f"{ctx.mix['driver']}.py")
    rec = driver.run(ctx)
    rec.update(setup_s=ctx.window_start - T_START, model=ctx.config["model"],
               config=ctx.config, mix=ctx.mix)
    metrics = {}
    for name, unit in metric_names(bench, args.workload, bool(args.trace)):
        value = load_module(BENCH / "metrics" / f"{name}.py").read(rec)
        if value is not None and math.isfinite(value):
            metrics[name] = {"value": value, "unit": unit}
    correct, checks = check.verdict(rec["numbers"], ctx.limits)
    result = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                         "count": entry["chips"],
                         "memory_peak_bytes": rec["memory_peak_bytes"]}}
    summary = rec.get("trace")
    if args.trace and summary is not None:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = trace.breakdown(summary)
    result["checks"] = checks
    result["record"] = rec
    return result


def main(argv=None) -> int:
    args = parse(argv)
    result = measure(args)
    rec = result.pop("record")
    for k, v in rec["numbers"].items():
        if k not in result["checks"]:
            Context.log(f"reading {k} {v!r}")
    found = forbidden_modules()
    if found:
        print(f"bench: the process loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"bench: check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
