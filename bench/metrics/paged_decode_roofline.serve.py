"""The traced stretch's paged decode launches (one a layer and microstep):
their least time by the live slots' K / V rows over the profiler's time of
the kernel."""
from costs import kernels as K
from harness.readers import kernel_bounds, roofline_pct, traced_steps


def read(r):
    dec, _ = kernel_bounds(r, traced_steps(r))
    return roofline_pct(r, K.PAGED_DECODE, dec)
