"""Seconds ``make_world`` took, from the benchmark's span around it (the
builder's tables to the device; the Python loop that stages the bodies
is before the span). Layer: the world API. Moves ``setup_s``."""


def read(ctx):
    return ctx.spans.get("make_world")
