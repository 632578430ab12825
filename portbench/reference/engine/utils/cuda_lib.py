"""The reference's stand-in for the program's kernel loader.

Every kernel wrapper of this copy asks ``on_cpu`` whether to take its plain
PyTorch version; here the answer is always yes, on the CPU and on the card
alike, so no hand-written kernel is built, loaded or launched. The other
helpers exist only so that the wrappers' unreachable launch branches
import; calling one raises.
"""
from __future__ import annotations

import contextlib
import threading

import torch

DEVICE_LAUNCHES: dict = {}
_scope = threading.local()


def on_cpu(*ts) -> bool:
    """Always True: the plain version, on any device."""
    return True


def _no_kernels(*a, **k):
    raise RuntimeError("the reference runs no hand-written kernel")


load = check = stream = launched = _no_kernels


@contextlib.contextmanager
def shard_scope(index: int, device):
    """The shard's device as the current one (the program's scope, without
    its launch counts)."""
    if torch.device(device).type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield
