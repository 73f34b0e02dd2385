"""Milliseconds a round in which the device was idle inside the program's
span ``fps`` (the furthest point sampling loop): the idle gaps of a
profiled round with the tracer on, put down by ``gpubench/spans.py``."""


def read(ctx):
    idle = ctx.get("program_idle")
    if not idle or not idle.get("units"):
        return None
    return idle["idle_s"].get("fps", 0.0) / idle["units"] * 1e3
