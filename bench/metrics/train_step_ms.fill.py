"""Mean device time of the window's train steps (CUDA events around the
callable the runtime calls)."""


def read(r):
    ms = r.get("train_ms")
    return sum(ms) / len(ms) if ms else None
