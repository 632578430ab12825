"""Seconds from the process's start to the window's first frame: import,
scene, world, seating, prelude, warm-up (and, in a checkout's first run,
the build of the program's CUDA libraries)."""


def read(ctx):
    return ctx.setup_s
