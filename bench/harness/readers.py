"""What the metric readers under ``bench/metrics/`` share: the tail rule,
the device's idle share, and the per-step work the roofline readers count
from the engine steps the harness recorded."""
from __future__ import annotations

import math

from costs import kernels as K
from costs import model as C
from harness import trace


def p95(values: list) -> float | None:
    """The 95th percentile by nearest rank (a missing answer is infinite)."""
    if not values:
        return None
    xs = sorted(values)
    return xs[max(math.ceil(0.95 * len(xs)) - 1, 0)]


def window_steps(r: dict) -> list:
    """The engine steps of the window (none of those under the profiler
    after it)."""
    return [s for s in r["steps"] if not s["traced"]]


def traced_steps(r: dict) -> list:
    """The engine steps of the stretch whose device trace the record holds
    (stretch 1 of ``trace.Tracer``)."""
    return [s for s in r["steps"] if s["traced"] == 1]


def decode_only(r: dict) -> list:
    """The window's steps that decoded and prefilled nothing."""
    return [s for s in window_steps(r) if s["k"] and not s["prefill_tokens"]]


def fill_seconds(r: dict) -> float | None:
    """The window's iterations' wall less their train steps' device time."""
    its, ms = r.get("iterations"), r.get("train_ms")
    if not its or not ms:
        return None
    return sum(it - t / 1e3 for it, t in zip(its, ms, strict=True))


def idle_pct(r: dict) -> float | None:
    s = r.get("trace")
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def decode_lengths(step: dict) -> list:
    """Each decode microstep's live key counts: a slot with ``n`` keys and
    ``left`` tokens to go decodes ``min(k, left)`` microsteps, the j-th over
    ``n + j`` keys."""
    return [[n + j for n, left in step["decoding"] if j < left] for j in range(step["k"])]


def prefill_waves(step: dict, chunk: int) -> list:
    """Each chunk wave's ``(start, length)`` chunks: every prompt admitted
    in the step streams whole (the budget is unmetered), ``chunk`` tokens a
    wave from its start."""
    waves = []
    for w in range(max((-(-p // chunk) for p in step["admitted"]), default=0)):
        waves.append([(w * chunk, min(chunk, p - w * chunk)) for p in step["admitted"]
                      if p > w * chunk])
    return waves


def roofline_pct(r: dict, symbols: tuple, bound_s: float) -> float | None:
    """``bound_s`` (the least time of the launches the traced stretch
    held) over the profiler's time of the kernels named ``symbols``."""
    s = r.get("trace")
    if s is None:
        return None
    secs, n = trace.kernel_time(s, *symbols)
    if n == 0 or secs <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / secs


def launches(r: dict, symbols: tuple) -> int:
    s = r.get("trace")
    return 0 if s is None else trace.kernel_time(s, *symbols)[1]


def engine_shape(r: dict) -> tuple:
    m, e = r["model"], r["config"]["engine"]
    return (e["slots"], m["num_heads"], m["num_kv_heads"], m["head_dim"],
            e["max_seq"] // e["page"] + 1, e["chunk"])


def decode_bound_s(m: dict, steps: list) -> float:
    """Least time of the decode microsteps of ``steps``, whole model."""
    return sum(C.decode_step_bound_s(m, lens) for st in steps for lens in decode_lengths(st) if lens)


def kernel_bounds(r: dict, steps: list) -> tuple:
    """(paged decode, paged prefill) least seconds over ``steps``, every
    layer's launch."""
    m = r["model"]
    b, h, kvh, hd, cols, chunk = engine_shape(r)
    dec = pre = 0.0
    for st in steps:
        for lens in decode_lengths(st):
            dec += K.bound_s(*K.paged_decode(b, h, kvh, hd, lens, cols))
        for wave in prefill_waves(st, chunk):
            pre += K.bound_s(*K.paged_prefill(b, chunk, h, kvh, hd, wave, cols))
    return dec * m["num_layers"], pre * m["num_layers"]
