"""The 90th percentile of the window's frame times (host clock, each frame
from its start to the end of its read-back), in ms: the hitch a game
feels when the pile lands."""
import numpy as np


def read(ctx):
    if not ctx.frames:
        return None
    return 1e3 * float(np.percentile(ctx.frame_s, 90))
