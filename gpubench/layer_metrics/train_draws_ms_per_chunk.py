"""Milliseconds of host work in the program's span ``chunk.draws``
(``ChunkRunner.run``: the K iterations' eager draws), the mean over the
chunks of the profiled segment with the tracer on (``gpubench/spans.py``):
the span less the time its launches waited for room in the device's
command buffer, which is the wait for the previous chunk's replay."""


def read(ctx):
    idle = ctx.get("program_idle") or {}
    draws = (idle.get("spans_s") or {}).get("chunk.draws")
    if not draws:
        return None
    blocked = (idle.get("blocked_s") or {}).get("chunk.draws", 0.0)
    return (sum(draws) - blocked) / len(draws) * 1e3
