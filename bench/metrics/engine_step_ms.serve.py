"""Mean host wall time of the window's ``EngineCore.step()``
calls."""
from harness.readers import window_steps


def read(r):
    steps = window_steps(r)
    return 1e3 * sum(s["t1"] - s["t0"] for s in steps) / len(steps) if steps else None
