"""Milliseconds a frame of the step's ``solve`` span on the device's clock
(the scatter plan, restitution, warm start, velocity and position loops
with their kernels, the integration), over the traced frames. Layer: the
solver loops. Moves the cell's frame rate (``steps_per_s``;
``steps_per_s.65k`` as ``<name>.65k``)."""
from harness import spans


def read(ctx):
    return spans.span_ms(ctx, "solve")
