"""The yardstick of the kernels' roofline shares: the card's peaks and each
solver kernel's bytes and operations per launch, reckoned from the live
contact rows of the launch's step (``live_rows``) and the world's width.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
A kernel's least time is the larger of its bytes over the memory rate and
its operations over the float rate of its type. Bytes count each input
byte once and each output byte once (the arithmetic of the repository's
``chip_smoke.py`` when the benchmark was written): the table rows the
kernel reads, the impulses in and out, the int32 endpoints and term
positions, the [N,6] body deltas once. The endpoint loads by index hit L2
and are not counted. Rows are the step's live contact rows, not the
padded width the kernels run over (padding is the kernels' waste, not
the inputs' need). The live terms that the fused iterations write and
``segment_sum`` reads are not counted: nothing outside the program says
how many a launch had, so every share here is a lower bound of the true
one.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {4: 67e12, 8: 34e12}  # float32, float64 outside tensor cores
KIND_STATIC = 2
C_BASE, C_SR = 65, 32
ROWS_READ = {"solve_iteration_fused": C_BASE - 9,
             "restitution_iteration_fused": 51,
             "ngs_iteration_fused": 20,
             "relvel_fused": 11}
FLOPS_K1 = {False: 150, True: 250}
FLOPS = {"restitution_iteration_fused": 150, "ngs_iteration_fused": 60,
         "relvel_fused": 31}


def live_rows(state):
    """The live contact rows of the step that made ``state`` (on the
    device, not read): the valid contact points of manifolds whose bodies
    both have a material and are not both inactive (asleep or static), as
    the contact rows are defined (the reference's ``build_contact_rows``)."""
    man = state.contacts
    inactive = state.asleep | ((state.kind == KIND_STATIC) & state.valid)
    code = state.has_material.int() + 2 * inactive.int()
    ca, cb = code[man.body_a.long()], code[man.body_b.long()]
    elig = man.valid & (ca & 1 > 0) & (cb & 1 > 0) \
        & ~((ca & 2 > 0) & (cb & 2 > 0))
    return (man.point_valid & elig[:, None]).sum()


def work(kernel: str, rows: int, n_bodies: int, es: int,
         with_sr: bool) -> tuple:
    """(bytes, operations) of one launch of ``kernel`` in a step of
    ``rows`` live contact rows on a world of ``n_bodies`` slots and
    ``es``-byte floats."""
    body = es * 6 * n_bodies
    if kernel == "segment_sum":
        return 4 * (n_bodies + 1) + 2 * body, 0
    idx = 4 * 2 * rows * 2
    if kernel == "solve_iteration_fused":
        r = ROWS_READ[kernel] + (C_SR if with_sr else 0)
        return es * rows * (r + 12) + idx + body, rows * FLOPS_K1[with_sr]
    if kernel == "restitution_iteration_fused":
        return es * rows * (ROWS_READ[kernel] + 2 + 6) + idx + body, \
            rows * FLOPS[kernel]
    if kernel == "ngs_iteration_fused":
        return es * rows * (ROWS_READ[kernel] + 1) + idx + body, \
            rows * FLOPS[kernel]
    if kernel == "relvel_fused":
        return es * rows * (ROWS_READ[kernel] + 2) + 4 * 2 * rows + body, \
            rows * FLOPS[kernel]
    raise KeyError(kernel)


def least_seconds(nbytes: float, ops: float, es: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOPS_PER_S[es])
