"""Trace schema (own copy of ``repro.obs.schema``): the authoritative field
list for every event kind the step tracer emits, plus a dependency-free
validator CI runs over the JSONL artifact.

The schema is deliberately plain data — ``{kind: {field: type-spec}}`` —
so the validator needs no third-party jsonschema package (nothing may be
pip-installed in CI beyond the baked image).  A type-spec is a type, a
tuple of types (union), or the sentinel ``NULLABLE(t)`` meaning ``t`` or
None.  Unknown extra fields are allowed (forward compatibility); missing
or mistyped required fields are errors.
"""
from __future__ import annotations

__all__ = ["EVENT_SCHEMAS", "INSTANT_ARG_SCHEMAS", "SPAN_ARG_SCHEMAS",
           "validate_event", "validate_events", "validate_jsonl"]


def NULLABLE(t):
    return (t, type(None))


_NUM = (int, float)

#: kind -> required fields.  ``seq`` is stamped on every recorded event;
#: the meta header (first JSONL line) is validated separately.
EVENT_SCHEMAS = {
    "quantum": {
        "t0": _NUM, "t1": _NUM, "seq": int, "args": dict,
    },
    "span": {
        "name": str, "track": str, "t0": _NUM, "t1": _NUM, "seq": int,
        "args": dict,
    },
    "instant": {
        "name": str, "track": str, "t": _NUM, "seq": int, "args": dict,
    },
    "transition": {
        "request_id": int, "frm": NULLABLE(str), "to": str, "t": _NUM,
        "seq": int, "priority": NULLABLE(str),
    },
}

META_SCHEMA = {"version": int, "events": int, "dropped": int}

#: the request states a transition may name (serving.core.RequestState
#: values; a new state must be added here AND to the attribution buckets)
TRANSITION_STATES = {
    "waiting", "prefilling", "running", "preempted",
    "finished_stopped", "finished_length", "finished_aborted",
    "finished_expired", "finished_error",
}

#: span/instant names with a pinned ``args`` contract (DESIGN.md §11).
#: Other names stay free-form; these are recovery's attribution-critical
#: events, so their args are part of the schema.
SPAN_ARG_SCHEMAS = {
    "recovery": {"requests": int, "tokens": int, "clock_shift": _NUM},
}
INSTANT_ARG_SCHEMAS = {
    "arrival_restamp": {"request_id": int, "old": _NUM, "new": _NUM},
}


def _check_fields(ev: dict, schema: dict, where: str, errors: list) -> None:
    for field, spec in schema.items():
        if field not in ev:
            errors.append(f"{where}: missing field {field!r}")
        elif not isinstance(ev[field], spec):
            errors.append(
                f"{where}: field {field!r} has type "
                f"{type(ev[field]).__name__}, expected {spec}"
            )


def validate_event(ev, where: str = "event") -> list:
    """Structural errors for one event dict (empty list = valid)."""
    errors: list = []
    if not isinstance(ev, dict):
        return [f"{where}: not an object"]
    kind = ev.get("type")
    if kind == "meta":
        _check_fields(ev, META_SCHEMA, where, errors)
        return errors
    schema = EVENT_SCHEMAS.get(kind)
    if schema is None:
        return [f"{where}: unknown event type {kind!r}"]
    _check_fields(ev, schema, where, errors)
    if errors:
        return errors
    if "t0" in schema and ev["t1"] < ev["t0"]:
        errors.append(f"{where}: t1 < t0 ({ev['t1']} < {ev['t0']})")
    if kind == "transition":
        if ev["to"] not in TRANSITION_STATES:
            errors.append(f"{where}: unknown state {ev['to']!r}")
        if ev["frm"] is not None and ev["frm"] not in TRANSITION_STATES:
            errors.append(f"{where}: unknown state {ev['frm']!r}")
    elif kind == "span":
        args_schema = SPAN_ARG_SCHEMAS.get(ev["name"])
        if args_schema is not None:
            _check_fields(ev["args"], args_schema, f"{where}.args", errors)
    elif kind == "instant":
        args_schema = INSTANT_ARG_SCHEMAS.get(ev["name"])
        if args_schema is not None:
            _check_fields(ev["args"], args_schema, f"{where}.args", errors)
    return errors


def validate_events(events, max_errors: int = 20) -> list:
    """Validate a sequence of event dicts: per-event structure plus the
    stream invariants (strictly increasing ``seq``, non-negative clock)."""
    errors: list = []
    prev_seq = -1
    for i, ev in enumerate(events):
        errors.extend(validate_event(ev, f"event[{i}]"))
        if isinstance(ev, dict) and isinstance(ev.get("seq"), int):
            if ev["seq"] <= prev_seq:
                errors.append(
                    f"event[{i}]: seq {ev['seq']} not increasing "
                    f"(prev {prev_seq})"
                )
            prev_seq = ev["seq"]
        if len(errors) >= max_errors:
            errors.append("... (further errors suppressed)")
            break
    return errors


def validate_jsonl(path: str, max_errors: int = 20) -> tuple:
    """Validate a JSONL trace file.  Returns ``(num_events, errors)``.
    Line 1 must be the meta header; every further line one event."""
    import json

    errors: list = []
    events: list = []
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        return 0, [f"{path}: empty file"]
    try:
        head = json.loads(lines[0])
    except json.JSONDecodeError as e:
        return 0, [f"{path}:1: not JSON ({e})"]
    if head.get("type") != "meta":
        errors.append(f"{path}:1: first line must be the meta header")
    else:
        errors.extend(validate_event(head, f"{path}:1"))
    for ln, line in enumerate(lines[1:], start=2):
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError as e:
            errors.append(f"{path}:{ln}: not JSON ({e})")
            if len(errors) >= max_errors:
                return len(events), errors
    errors.extend(validate_events(events, max_errors=max_errors))
    if head.get("type") == "meta" and head.get("events") != len(events):
        errors.append(
            f"{path}: meta header declares {head.get('events')} events, "
            f"file holds {len(events)}"
        )
    return len(events), errors
