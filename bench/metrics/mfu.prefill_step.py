"""The window's engine steps that prefilled: their model operations (the
prompts' tokens and causal pairs, and their decode microsteps) at the 989
TFLOP/s bfloat16 peak, over their wall time."""
from costs.model import PEAK_BF16_FLOPS, tokens_flops
from harness.readers import decode_lengths, window_steps


def read(r):
    steps = [s for s in window_steps(r) if s["prefill_tokens"]]
    wall = sum(s["t1"] - s["t0"] for s in steps)
    if wall <= 0:
        return None
    m = r["model"]
    flops = 0.0
    for s in steps:
        flops += sum(tokens_flops(m, p, p * (p + 1) // 2) for p in s["admitted"])
        flops += sum(tokens_flops(m, len(lens), sum(lens)) for lens in decode_lengths(s))
    return 100.0 * flops / wall / PEAK_BF16_FLOPS
