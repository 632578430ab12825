"""Nonlinear Gauss-Seidel position correction, linearized and batched
(counterpart of ``edyn_tpu/dynamics/position.py``; reference:
position_solver.hpp:13-52, contact_constraint.cpp:60-94).

Reuses the velocity solver's packed row table: each iteration is
gather -> K2 (``solver_kernels.ngs_iteration``) -> scatter-add, with the
reference's early exit once the largest error drops below 0.005.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import CONTACT_POSITION_CORRECTION_RATE
from ..math import quat, vec
from . import solver_kernels as sk
from .solver import scatter_upd_t

MAX_CORRECTION = 0.05  # metres of positional error consumed per iteration
ERROR_EXIT = 0.005


def solve_positions(state, tbl, ab_p, num_iterations: int):
    if num_iterations <= 0:
        return state
    N = state.capacity
    dpq_t = torch.zeros((6, N), dtype=tbl.dtype, device=tbl.device)
    for _ in range(num_iterations):
        upd, err = sk.ngs_iteration(tbl, dpq_t[:, ab_p],
                                    float(CONTACT_POSITION_CORRECTION_RATE),
                                    float(MAX_CORRECTION))
        dpq_t = scatter_upd_t(dpq_t, ab_p, upd)
        # device branch (position.py:59 and :109 in the JAX package):
        # host-synced early exit
        if not bool(torch.amax(err) >= ERROR_EXIT):
            break
    dpq = dpq_t.T
    dang = vec.clamp_length(dpq[:, 3:6], 0.2)
    dpos = vec.clamp_length(dpq[:, 0:3], 3 * MAX_CORRECTION)
    return dataclasses.replace(state, pos=state.pos + dpos,
                               orn=quat.integrate(state.orn, dang, 1.0))
