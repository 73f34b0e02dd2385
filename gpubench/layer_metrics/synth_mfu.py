"""The whole synthesis round's share of the card's peaks: the sum of the
least times of the work a round needs (K1's needed pairs at the FP32
rate, FPS of the fakes at the FP32 rate or its bytes, the generator's FLOP
at the bf16 rate) over the window's seconds a round.  It bounds a gain
whatever implements K1, FPS or the generator."""

from gpubench.rooflines import bf16_least_s, fps_least_s, k1_least_s


def read(ctx):
    if not ctx.get("gen_flop_per_round") or not ctx.get("rounds"):
        return None
    least = (k1_least_s(ctx["pairs_per_round"], ctx["points"], 2 * ctx["clouds"])
             + fps_least_s(ctx["clouds"], ctx["scan_points"], ctx["points"])
             + bf16_least_s(ctx["gen_flop_per_round"]))
    return 100.0 * least * ctx["rounds"] / ctx["window_s"]
