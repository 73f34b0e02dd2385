"""Milliseconds a round of the program's span ``cd.scores`` (COV, MMD and
1-NNA on the host from the three Chamfer matrices), in a round run with
the tracer on and no profiler (``gpubench/spans.py``)."""


def read(ctx):
    prog = ctx.get("program") or {}
    spans = prog.get("spans_s", {}).get("cd.scores")
    return sum(spans) / prog["units"] * 1e3 if spans and prog.get("units") else None
