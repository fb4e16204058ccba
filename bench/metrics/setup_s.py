"""Seconds from the process's start to the window's start: loading, making
the weights, building, warming up and compiling."""


def read(r):
    return r["setup_s"]
