"""OFFLINE microsteps the runtime counted in the window times the
calibrated microstep, over the profile's bubble time of the window's
iterations."""


def read(r):
    if not r.get("iterations"):
        return None
    return 100.0 * r["offline_microsteps"] * r["microstep_s"] / (
        len(r["iterations"]) * r["bubble_s"])
