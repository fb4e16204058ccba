"""The traced stretch's chunked-prefill launches (one a layer and wave):
their least time by the chunks and their prefixes over the profiler's time
of the kernel."""
from costs import kernels as K
from harness.readers import kernel_bounds, roofline_pct, traced_steps


def read(r):
    _, pre = kernel_bounds(r, traced_steps(r))
    return roofline_pct(r, K.PAGED_PREFILL, pre)
