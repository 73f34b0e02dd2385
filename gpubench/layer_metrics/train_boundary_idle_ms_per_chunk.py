"""Milliseconds a chunk in which the device was idle while the program's
innermost open span was ``chunk`` or one of its parts (``chunk.draws``,
``chunk.upload``, ``chunk.launch``): the idle gaps of a profiled segment
with the tracer on, put down by ``gpubench/spans.py``, over its chunks."""


def read(ctx):
    idle = ctx.get("program_idle")
    if not idle or not idle.get("units"):
        return None
    s = sum(v for k, v in idle["idle_s"].items() if k == "chunk" or k.startswith("chunk."))
    return s / idle["units"] * 1e3
