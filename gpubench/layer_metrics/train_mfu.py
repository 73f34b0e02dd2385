"""The window's share of the card's dense bf16 peak: the FLOP of one train
step, counted on the plain reference at the cell's shapes, times the
window's steps, over the window's seconds times 989 TFLOP/s."""

from gpubench.rooflines import PEAK_BF16_FLOP_PER_S


def read(ctx):
    if not ctx.get("flop_per_step") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["flop_per_step"] * ctx["window_steps"] / (
        ctx["window_s"] * PEAK_BF16_FLOP_PER_S)
