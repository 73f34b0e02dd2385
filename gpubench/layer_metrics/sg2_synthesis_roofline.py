"""The modulated synthesis's share of the card's dense bf16 peak: the FLOP
of a step's synthesis forwards (the D phase's fakes and the G phase's at
the batch, the path length's at its rows), counted on the plain reference,
times the traced diagnostic's steps, over 989 TFLOP/s times the device
seconds of the kernels launched under the program's span ``g.synthesis``
in those steps."""

from gpubench.rooflines import PEAK_BF16_FLOP_PER_S


def read(ctx):
    if not ctx.get("synthesis_device_s") or not ctx.get("synthesis_flop_per_step"):
        return None
    return 100.0 * ctx["synthesis_flop_per_step"] * ctx["diagnostic_steps"] / (
        ctx["synthesis_device_s"] * PEAK_BF16_FLOP_PER_S)
