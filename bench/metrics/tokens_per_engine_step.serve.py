"""The window's change of ``engine/generated_tokens`` over its change of
``engine/steps_executed`` (the engine's own counters)."""


def read(r):
    n = r.get("engine_steps")
    return r["engine_tokens"] / n if n else None
