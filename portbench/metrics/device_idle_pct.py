"""The share of the traced window in which no kernel, copy or set ran on
the device (the union of the profiler's device intervals). Layer: the
device. Moves the cell's frame rate
(``steps_per_s``; ``steps_per_s.65k`` as ``<name>.65k``)."""


def read(ctx):
    if not ctx.trace or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
