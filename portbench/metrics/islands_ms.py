"""Milliseconds a frame of the step's ``islands`` span on the device's clock
(the steady-state skip, labels, sleep timers), over the traced frames.
Layer: islands and sleep. Moves the cell's frame rate (``steps_per_s``;
``steps_per_s.65k`` as ``<name>.65k``)."""
from harness import spans


def read(ctx):
    return spans.span_ms(ctx, "islands")
