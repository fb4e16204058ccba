"""OFFLINE tokens generated in a serving window, over the window's seconds:
the residual the ONLINE load leaves the backlog (the end-to-end
``offline_tokens_per_s`` of a fill cell, read here beside the tails)."""


def read(r):
    return r["offline_tokens"] / r["window_s"]
