"""Milliseconds a frame of the step's ``narrowphase`` span on the device's
clock (classify, K4 and the plain buckets, the merge), over the traced
frames. Layer: the narrowphase. Moves the cell's frame rate
(``steps_per_s``; ``steps_per_s.65k`` as ``<name>.65k``)."""
from harness import spans


def read(ctx):
    return spans.span_ms(ctx, "narrowphase")
