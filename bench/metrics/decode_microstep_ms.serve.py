"""Wall time of the window's decode-only engine steps (no prefill
token) over the microsteps they ran."""
from harness.readers import decode_only


def read(r):
    steps = decode_only(r)
    k = sum(s["k"] for s in steps)
    return 1e3 * sum(s["t1"] - s["t0"] for s in steps) / k if k else None
