"""Microseconds of the program's span ``fps`` a step of the loop: the
spans' total over the counter ``fps.steps`` (k - 1 a call), in a round
run with the tracer on and no profiler (``gpubench/spans.py``)."""


def read(ctx):
    prog = ctx.get("program") or {}
    steps = prog.get("counters", {}).get("fps.steps")
    spans = prog.get("spans_s", {}).get("fps")
    return sum(spans) / steps * 1e6 if spans and steps else None
