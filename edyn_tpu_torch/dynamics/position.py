"""Nonlinear Gauss-Seidel position correction, linearized and batched
(counterpart of ``edyn_tpu/dynamics/position.py``; reference:
position_solver.hpp:13-52, contact_constraint.cpp:60-94).

Reuses the velocity solver's packed row table: each iteration is
gather -> K2 (``solver_kernels.ngs_iteration``) -> scatter-add, with the
reference's early exit once the largest error drops below 0.005. On the
card it runs under the step's ``scatter.ScatterPlan``: the fused K2
(``solver_kernels.ngs_iteration_fused``) reads the [N,8] body deltas by
index and writes its terms where the plan puts them, and the plan's
segment sums add them, with the same result bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import CONTACT_POSITION_CORRECTION_RATE
from ..math import quat, vec
from ..parallel.collectives import Mesh
from ..utils.profile import host
from . import solver_kernels as sk
from .scatter import ScatterPlan
from .solver import ShardPack, chain_upd_t

MAX_CORRECTION = 0.05  # metres of positional error consumed per iteration
ERROR_EXIT = 0.005


def solve_positions(state, tbl, ab_p, num_iterations: int):
    return solve_positions_sharded(state, [ShardPack.of_table(tbl, ab_p)],
                                   Mesh((tbl.device,)), num_iterations)


def solve_positions_sharded(state, packs, mesh: Mesh, num_iterations: int,
                            plan: ScatterPlan | None = None):
    """``solve_positions`` over the shards' row tables
    (``solver.ShardPack``): K2 per shard on its device, the updates met in
    ``solver.chain_upd_t``, the early exit on the largest error of any
    shard. Equal to ``solve_positions`` over the concatenated rows. Under
    the step's ``plan`` (the card) each iteration is the fused K2 per shard
    and the plan's segment sums, with the same result. Every term position
    the plan keeps is rewritten by each iteration, so the terms buffers,
    shared with K1 and K3a, need no zeroing."""
    if num_iterations <= 0:
        return state
    N, dtype = state.capacity, packs[0].tbl.dtype
    rate = float(CONTACT_POSITION_CORRECTION_RATE)
    most = float(MAX_CORRECTION)
    # the deltas: [6,N] gathered by ab_p, or the fused K2's [N,8] body table
    d = torch.zeros((6, N) if plan is None else (N, 8), dtype=dtype,
                    device=mesh.home)
    for _ in range(num_iterations):
        upds, err_max = [], None
        for s, p in enumerate(packs):
            with mesh.scope(s):
                if plan is None:
                    upd, err = sk.ngs_iteration(
                        p.tbl, d.to(p.device)[:, p.ab_p], rate, most)
                    upds.append(upd)
                else:
                    t = plan.shards[s]
                    err = sk.ngs_iteration_fused(
                        p.tbl, d.to(p.device), t.ab, t.pos, t.terms_a,
                        t.terms_b, rate, most)
                e = torch.amax(err).to(mesh.home)
                err_max = e if err_max is None else torch.maximum(err_max, e)
        d = (chain_upd_t(d, packs, upds, mesh) if plan is None
             else plan.add(d, mesh))
        # device branch (position.py:59 and :109 in the JAX package):
        # host-synced early exit
        if not host("position.early_exit", bool(err_max >= ERROR_EXIT)):
            break
    return _apply_correction(
        state, d if plan is None else d[:, :6].T.contiguous())


def _apply_correction(state, dpq_t):
    dpq = dpq_t.T
    dang = vec.clamp_length(dpq[:, 3:6], 0.2)
    dpos = vec.clamp_length(dpq[:, 0:3], 3 * MAX_CORRECTION)
    return dataclasses.replace(state, pos=state.pos + dpos,
                               orn=quat.integrate(state.orn, dang, 1.0))
