"""K1's share of its roofline in the traced round: the least time of the
pairs the protocol needs (``rooflines.k1_least_s``: 8 FP32 operations a
distance at 67 TFLOP/s, or the clouds' bytes at 3.35 TB/s, whichever is
longer) over K1's device time, summed by kernel name from the trace."""

from gpubench.rooflines import k1_least_s


def read(ctx):
    t = ctx.get("trace") or {}
    k1_s = sum(v for k, v in t.get("device_s_by_name", {}).items() if "cd_block" in k)
    if not k1_s or not ctx.get("pairs_per_round"):
        return None
    least = k1_least_s(ctx["pairs_per_round"], ctx["points"], 2 * ctx["clouds"])
    return 100.0 * least / k1_s
