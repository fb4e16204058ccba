"""The knee of a serving cell: one engine set up and warmed once, then a
window at each ONLINE rate in turn (the OFFLINE backlog present throughout),
each followed by a drain of its ONLINE requests.  For each rate it prints
the requests due and finished in the window, the time-averaged number of
ONLINE requests outstanding (due and not finished) in each quarter of the
window, the OFFLINE tokens a second, and the TTFT / latency tails from the
due instant.  The knee is the highest rate whose outstanding count does not
grow across the window.

  python3 bench/sweep.py --workload olmo-1b.serve-online --rates 4,8,12 --seconds 20
"""
import argparse
import collections
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    a = ap.parse_args(argv)
    import torch

    from harness import gpu, readers, trace

    gpu.require(1)
    gpu.keep_caches_in(run.CHECKOUT)
    run.Context.log(f"card: {gpu.card()}")
    cell = run.load_json("workloads", a.workload + ".json")
    args = run.parse(["--workload", a.workload, "--seed", str(a.seed), "--seconds", "1"])
    ctx = run.Context(args, cell, torch.device("cuda"), trace.Tracer(False))
    serve = run.load_module(run.BENCH / "drivers" / "serve.py")
    eng, loop = serve.build(ctx)
    serve.warm_up(eng, loop, ctx.mix, a.seed)
    for i, rate in enumerate(float(r) for r in a.rates.split(",")):
        ctx.mix["online"]["rate"] = rate
        loop.tracked.clear()
        pending = loop.schedule("online", a.seconds, a.seed + i, ctx.mix["mix_seed"])
        n = len(pending)
        t0 = time.monotonic()
        pending = collections.deque((t0 + due, *rest) for due, *rest in pending)
        off = eng.obs.metrics.counter("core/generated_tokens/offline")
        off0 = off.value
        loop.drive(pending, t0 + a.seconds)
        loop.submit_due(pending, t0 + a.seconds)
        t1 = time.monotonic()
        window = dict(loop.tracked)
        loop.drive(collections.deque(), time.monotonic() + 120,
                   done=lambda: all(e[2] is not None for e in window.values()))
        rows = list(window.values())
        out = []
        for q in range(4):
            ts = [t0 + (q + (j + 0.5) / 100) * a.seconds / 4 for j in range(100)]
            out.append(sum(1 for t in ts for e in rows if e[0] <= t and (e[2] is None or e[2] > t))
                       / len(ts))
        inf = float("inf")
        ttft = [(e[1] - e[0]) * 1e3 if e[1] else inf for e in rows]
        print(json.dumps({"rate": rate, "due": n,
                          "finished_in_window": sum(1 for e in rows
                                                    if e[2] and e[2] <= t0 + a.seconds),
                          "outstanding_by_quarter": [round(x, 2) for x in out],
                          "offline_tokens_per_s": (off.value - off0) / (t1 - t0),
                          "ttft_p50_ms": sorted(ttft)[len(ttft) // 2] if ttft else None,
                          "ttft_p95_ms": readers.p95(ttft),
                          "latency_p95_ms": readers.p95([(e[2] - e[0]) * 1e3 if e[2] else inf
                                                         for e in rows])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
