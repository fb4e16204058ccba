"""95th percentile, over every ONLINE request due in the window, of the
time from its due instant to the step that returned its last token (one
that never finished counts as infinite)."""
from harness.readers import p95


def read(r):
    if "online" not in r:
        return None
    return p95([(done - due) * 1e3 if done is not None else float("inf")
                for due, _, done in r["online"]])
