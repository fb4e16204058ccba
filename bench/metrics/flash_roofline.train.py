"""The flash forward and backward launches of the traced stretch: their
least time at the card's peaks over the profiler's time of their kernels."""
from costs import kernels as K
from harness.readers import launches, roofline_pct


def read(r):
    t, m = r["config"]["train"], r["model"]
    shape = (t["batch"], m["num_heads"], t["seq_len"], m["head_dim"])
    fwd, bwd = launches(r, K.FLASH_FWD), launches(r, K.FLASH_BWD[1:2])
    bound = fwd * K.bound_s(*K.flash_fwd(*shape)) + bwd * K.bound_s(*K.flash_bwd(*shape))
    return roofline_pct(r, K.FLASH_FWD + K.FLASH_BWD, bound)
