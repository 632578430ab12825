"""Restitution outer passes a frame run before the pre-pass's early exit (the
program's counter ``restitution_passes``), over the traced frames.
Layer: the solver loops. Moves the cell's frame rate (``steps_per_s``;
``steps_per_s.65k`` as ``<name>.65k``)."""
from harness import spans


def read(ctx):
    return spans.per_frame(ctx, "restitution_passes")
