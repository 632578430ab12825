"""The program's own spans and counters of a traced run
(``edyn_tpu_torch.utils.profile``), for the per-layer metrics.

The program records every step it takes while a profiler records (the
traced part of the window), each phase of ``physics_step`` as a span with
its extent on the device's clock, and counters (host syncs, restitution
passes, bucket pairs). A reader gets nothing (None) from a program without
``profile.recorded``, or when the steps it recorded are not the traced
frames (a step recorded outside them, or one missed).
"""
from __future__ import annotations


def recorded(ctx):
    """The program's ``recorded()`` when its steps are the traced frames,
    else None."""
    if not ctx.trace or not ctx.trace.get("frames"):
        return None
    try:
        from edyn_tpu_torch.utils import profile
    except ImportError:
        return None
    read = getattr(profile, "recorded", None)
    if read is None:
        return None
    rec = read()
    if rec.get("steps") != ctx.trace["frames"]:
        return None
    return rec


def span_ms(ctx, name: str):
    """The span ``name``'s device milliseconds a frame."""
    rec = recorded(ctx)
    if rec is None or name not in rec["spans"]:
        return None
    return rec["spans"][name]["device_ms"] / rec["steps"]


def per_frame(ctx, counter: str):
    """The counter ``counter`` a frame (0 where the step never counted)."""
    rec = recorded(ctx)
    if rec is None:
        return None
    return rec["counters"].get(counter, 0) / rec["steps"]
