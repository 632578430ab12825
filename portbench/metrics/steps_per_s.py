"""Frames completed over the whole window, per second of it (host clock):
what a headless pipeline (replays, dataset generation, a server catching
up) pays for."""


def read(ctx):
    return ctx.frames / ctx.window_s if ctx.window_s > 0 else None
