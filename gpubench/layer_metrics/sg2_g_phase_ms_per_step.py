"""Device milliseconds of a train step's G phase: the kernels launched
under the range ``step.g`` that the driver's diagnostic opens around it
(G's forward, D's forward, the path length's double backward, G's Adam
update), each eager step of the traced run's diagnostic summed, the median
over its steps."""

import statistics


def read(ctx):
    ms = ctx.get("sg2_g_phase_ms")
    return statistics.median(ms) if ms else None
