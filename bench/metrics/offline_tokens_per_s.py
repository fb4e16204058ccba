"""OFFLINE tokens generated in the window, over the window's seconds."""


def read(r):
    return r["offline_tokens"] / r["window_s"]
