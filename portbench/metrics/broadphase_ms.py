"""Milliseconds a frame of the step's ``broadphase`` span on the device's
clock (the pair-list carry decision and the dense or sweep pass), over the
traced frames. Layer: the broadphase. Moves the cell's frame rate
(``steps_per_s``; ``steps_per_s.65k`` as ``<name>.65k``)."""
from harness import spans


def read(ctx):
    return spans.span_ms(ctx, "broadphase")
