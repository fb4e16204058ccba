"""The window's decode-only steps' least time at the card's peaks (each
microstep's operations at 989 TFLOP/s or its bytes at 3.35 TB/s: the
bfloat16 weights and the live slots' K / V, each read once), over their
wall time."""
from harness.readers import decode_bound_s, decode_only


def read(r):
    steps = decode_only(r)
    wall = sum(s["t1"] - s["t0"] for s in steps)
    bound = decode_bound_s(r["model"], steps)
    return 100.0 * bound / wall if wall > 0 and bound > 0 else None
