"""Device operations (kernels, copies, sets) a frame, over the traced
frames: what CUDA graphs or lighter wrappers would cut. Layer: step
dispatch. Moves the cell's frame rate
(``steps_per_s``; ``steps_per_s.65k`` as ``<name>.65k``)."""


def read(ctx):
    if not ctx.trace or not ctx.trace["frames"]:
        return None
    return ctx.trace["device_events"] / ctx.trace["frames"]
