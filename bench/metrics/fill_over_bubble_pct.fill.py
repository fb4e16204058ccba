"""The wall time of each ``rt.run(1)`` iteration of the window less its
train step's device time, summed, over the profile's bubble time of as many
iterations: above 100 the fill overran the bubbles it was granted."""
from harness.readers import fill_seconds


def read(r):
    fill = fill_seconds(r)
    if fill is None:
        return None
    return 100.0 * fill / (len(r["iterations"]) * r["bubble_s"])
