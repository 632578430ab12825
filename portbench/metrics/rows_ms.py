"""Milliseconds a frame of the step's ``rows`` span on the device's clock
(the contact rows' build, the ladder width, the shard cut, the pack), over
the traced frames. Layer: the contact rows. Moves the cell's frame rate
(``steps_per_s``; ``steps_per_s.65k`` as ``<name>.65k``)."""
from harness import spans


def read(ctx):
    return spans.span_ms(ctx, "rows")
