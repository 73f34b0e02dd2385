"""The window's share of the card's dense bf16 peak: the FLOP of one
inversion step (the generator's forward and the gradient for the latent,
at the cell's batch), counted on the plain reference, times the window's
steps, over the window's seconds times 989 TFLOP/s."""

from gpubench.rooflines import PEAK_BF16_FLOP_PER_S


def read(ctx):
    if not ctx.get("flop_per_step") or not ctx.get("batches"):
        return None
    steps = ctx["batches"] * ctx["steps"]
    return 100.0 * ctx["flop_per_step"] * steps / (ctx["window_s"] * PEAK_BF16_FLOP_PER_S)
