"""Share of the traced stretch's wall time in which no kernel ran."""
from harness.readers import idle_pct


def read(r):
    return idle_pct(r)
