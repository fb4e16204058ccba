"""Tokens trained per second: every step the window ran times its batch's
tokens, over the window's seconds."""


def read(r):
    if "iterations" not in r:
        return None
    return len(r["iterations"]) * r["tokens_per_step"] / r["window_s"]
