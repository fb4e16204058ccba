"""The train step's model operations (forward and backward products,
causal attention, the tied head once, no recompute) over its mean device
time at the card's 989 TFLOP/s bfloat16 peak."""
from costs.model import PEAK_BF16_FLOPS, train_step_flops


def read(r):
    ms = r.get("train_ms")
    if not ms:
        return None
    t = r["config"]["train"]
    flops = train_step_flops(r["model"], t["batch"], t["seq_len"])
    return 100.0 * flops / (sum(ms) / len(ms) / 1e3) / PEAK_BF16_FLOPS
