"""Host reads of a device value a frame inside the step (the program's
counter ``host_syncs``: each waits for the stream), over the traced
frames. Layer: step dispatch. Moves the cell's frame rate
(``steps_per_s``; ``steps_per_s.65k`` as ``<name>.65k``)."""
from harness import spans


def read(ctx):
    return spans.per_frame(ctx, "host_syncs")
