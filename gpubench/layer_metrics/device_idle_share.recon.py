"""The traced segment's share of time in which no operation ran on the
device: 1 - (union of the device events' intervals) / (the segment's
host-clock length)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
