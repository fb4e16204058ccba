"""OFFLINE tokens of the window over its fill's wall seconds: each
iteration's wall less its train step's device time."""
from harness.readers import fill_seconds


def read(r):
    fill = fill_seconds(r)
    return r["offline_tokens"] / fill if fill else None
