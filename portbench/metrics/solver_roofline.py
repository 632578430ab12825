"""The solver kernels' share of their roofline over the traced window:
the sum over every launch of ``vel_fused_kernel``, ``rest_fused_kernel``,
``ngs_fused_kernel``, ``relvel_fused_kernel`` and ``segment_sum_kernel``
of the least time it could take at its step's live contact rows
(``harness.roofline``), over the sum of their device times. A lower
bound: the live terms are not counted. Nothing
is read when no such launch was traced, or when the trace's launches of a
kernel are not the program's own count of them (then the trace missed
some). Layer: the solver kernels. Moves the cell's frame rate
(``steps_per_s``; ``steps_per_s.65k`` as ``<name>.65k``)."""
from harness import roofline


def read(ctx):
    if not ctx.trace:
        return None
    least = spent = 0.0
    for name, launches in ctx.trace["kernels"].items():
        if len(launches) != ctx.launches.get(name, 0):
            return None
        for frame, ns in launches:
            if frame is None or frame >= len(ctx.live_rows):
                return None
            nbytes, ops = roofline.work(name, ctx.live_rows[frame],
                                        ctx.n_bodies, ctx.es, ctx.with_sr)
            least += roofline.least_seconds(nbytes, ops, ctx.es)
            spent += ns * 1e-9
    if spent <= 0:
        return None
    return 100.0 * least / spent
