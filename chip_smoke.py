#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``edyn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the run then exits non-zero and
prints no result):

1. Device and build: the card's name and power limit from ``nvidia-smi``,
   then one ``nvcc`` per source of ``edyn_tpu_torch/csrc/`` (solver
   kernels K1-K3b, the UNIFIED narrowphase kernel K4, the overlap count
   K5, the manifold merge), all started together.
2. Kernels against their plain PyTorch versions on the card, on random
   inputs at the main path's full width: the solver kernels at C = 97
   table rows, Rp = 160,128; K4 on 190,000 random pairs of the 10k pile's
   side table (C = 84), with and without rim axes, equal to the plain
   version on every pair; K4's pre-pass and pair order equal to theirs; K5
   on 65,573 random AABBs and on its edge cases (N below one tile and not a
   multiple of it, every box invalid, infinite and 1e30 extents, touching
   faces), every count equal to the plain one. Max abs difference, the
   kernel's device time with its inputs read from device memory and with
   them in L2 (CUDA-graph replays), the plain version's, one call with its
   host work, and the bound; each kernel's registers, stack and spills from
   the build. Then the card's fused iterations (``check_fused``): one K1,
   one K3a and one K2 iteration by the fused path (``vel_fused_kernel``,
   ``rest_fused_kernel`` or ``ngs_fused_kernel``, then ``segment_sum`` over
   the step's scatter plan) bit-equal to the unfused path (gather,
   ``vel_kernel``, ``rest_kernel`` or ``ngs_kernel``, ``solver.index_sum``)
   and to the fused path's plain versions; ``segment_sum`` bit-equal to
   ``index_sum`` on the same terms, and on a run of ``STRESS_RUN`` terms
   beside empty runs (``segment_stress``); one restitution outer pass by
   the fused K3b (``relvel_fused_kernel``: the velocities read by index,
   rhs, activity and the early-exit flag written) bit-equal, dyn and flag,
   to the unfused pass (gather, ``relvel_kernel``, the glue, ``any``) and
   to its plain version, no flag with the velocities zero; each new
   kernel timed L2-cold beside its bound, its plain version and, for
   ``segment_sum``, ``index_sum`` (its ``library_ms``); both paths' time
   per iteration (K3b: per pass, in turns).
3. The main path: ``mixed_pile(10_000)`` -> ``make_world`` (cuda) ->
   ``World.step_n(120)``, with every kernel's launch count set to 0 just
   before and read just after. Checks finite state, launch counts within
   (0, per-step maximum x steps] (K1, K3a, K2 and K3b fused, with
   ``segment_sum``; their unfused kernels never), and the pile checks of
   the JAX package's
   ``test_mixed_pile_settles_and_no_tunnel`` (see ``FLOOR_BURIAL``); then
   the ``suggest_max_pairs`` entry point once on the landed pile (K5, its
   count equal to the plain one); then that JAX test itself, a 60-body pile
   settled for 240 steps, on the card.
4. The kernels again on a real step of that pile: the solver kernels on its
   packed row table, and the fused iterations as in phase 2 on its rows
   and its bodies (the static planes left out of the plan); K4 on its live
   UNIFIED pairs, equal to its plain
   version on every pair and against the port's
   ``support_sat.collide_support`` under the parity contract of
   ``tests/test_pallas_narrowphase.py``, timed with all its launches
   (pre-pass, pair order, per-pair kernel) and each step alone,
   beside two bounds: the live work (the plain version's operations with
   each side of a pair at its own real widths, the world rotations counted
   once per body for the pre-pass) and the padded work (at the table's
   widths, rotated per pair); also the per-pair kernel with the pairs in
   table order, and a stable ``torch.sort`` of the class bins, to weigh
   the pair order.
5. Card against CPU: one step of a settled 1,000-body pile, on the card
   (K4 in the UNIFIED bucket) and from a copy on the CPU (``support_sat``
   there, plain solver versions), held per body at the whole-step
   tolerances of the test suite (see ``card_vs_cpu``). Beside it, each in
   a process of its own (``beside``): phase 6's jointed card-vs-CPU check
   and the JAX package's ragdoll test, 12c and 13b below, none of which
   times anything; their summaries stand in phases 6, 12 and 13.
6. Joints: ``ragdoll_pile(edyn_tpu_torch)`` (768 ragdolls: 9,989 bodies,
   15,360 point, cone and hinge joints) -> ``make_world`` (cuda, with
   ``RAGDOLL_SETTINGS``' cone cap: ROADMAP R8) -> 120 ``World.step``
   calls, every launch count (K5's too) read as in phase 3 (K1, K2 and K4
   must run, K5 must not); checks finite state, every ragdoll's head and
   knees attached (the JAX package's limits), no centre out of the bin or
   above its start, and the deepest centre of any of the 120 steps above
   ``RAGDOLL_FLOOR``; prints steps/s, ms/step, the pivot gaps, live joint
   rows and launches per step. Then the kernels on a real step of that
   pile, as phase 4 holds them on the 10k pile: the solver kernels on its
   packed row table, K4 on its live UNIFIED pairs (against its plain
   version and against ``support_sat``). Run beside phase 5, each in a
   process of its own: card against CPU on a 16-ragdoll pile settled 240
   steps (the whole step under phase 5's rule, and ``build_joint_rows``,
   ``solve_joints_once`` and ``solve_joint_positions`` alone within
   ``JOINT_RTOL``), and the JAX package's ragdoll test (one ragdoll, 240
   steps, the default settings) on the card, with a second run equal to
   the first bit for bit after 60 steps.
7. Terrain: ``rich_scene(10_000)`` of ``edyn_tpu_torch`` (a 24 x 24
   trimesh terrain of 1,058 triangles over +-29.6 m, four wall planes,
   10,000 spheres, boxes, capsules and cylinders, four hinge chains of six
   links) -> ``make_world`` (cuda) -> 120 ``World.step`` calls, every
   launch count read as in phase 6 (K1, K2, K3b and K4 must run, K5 must
   not); checks finite state, no centre beyond the walls, every hinge
   pivot gap under ``PIVOT_GAP``, and the lowest centre above the terrain
   surface at its (x, z) over all 120 steps above ``TERRAIN_FLOOR``;
   prints steps/s, ms/step and the live MESH-bucket pairs. Then the path's
   kernels on that world's own step, as phase 6 holds them, and the fused
   iterations as phase 4 holds them.
8. Card against CPU on a ``rich_scene(512)`` settled 240 steps: the whole
   step under phase 5's rule, each body against its own 1-ulp sensitivity
   with positions and orientations nudged, then the MESH bucket alone
   (``narrowphase.bucket_points``) on its live pairs: the pairs whose
   points and normals agree within ``TOL`` everywhere, the others counted
   as feature flips (at most ``MESH_FLIP_SHARE`` of the pairs), every pair
   within the parity contract; then the opt-in triangle cull
   (``Settings.mesh_triangle_cull``) on that state: the points it removes
   and one step with it; ``examples/vehicle.py``'s vehicle (a compound
   chassis on hinged wheels) driven 120 frames on the card and on the CPU,
   x > 1.0 m on both; the JAX package's compound tests
   (``tests/test_torch_compound_behaviour.py``) on the card. The vehicle,
   the compound tests (in ``COMPOUND_PROCESSES`` shares) and 13a below run
   in processes of their own beside the rest of the phase: the phase times
   nothing, and 13a's steps/s are taken beside it.
9. ``bench.py``'s protocol: ``mixed_pile(10_000)`` -> ``make_world``
   (cuda, 256 spare slots) -> ``step_n(2)``, 60 falling steps timed, 300
   untimed, 60 settled steps timed, then ``bench.py``'s mostly-asleep
   set-up (``put_to_sleep``, the 100 highest bodies relaunched 25 m up,
   ``wake_set``) and 60 mostly-asleep steps timed, with the launch counts
   read over the protocol and over the mostly-asleep steps; fails below
   ``MIN_ASLEEP`` asleep, on a non-finite state or an overflow. The solver
   kernels and the fused iterations on that world's rows at the narrowed
   width. Then the live-world
   API on that world: 256 spawns into the spare slots and 256 destroys,
   the setters, 10 steps through ``step_with_events`` (every spawned body
   that touches has a started contact), 4,096 vertical rays on the card
   against a CPU copy, ``query_aabb`` against a numpy brute force.
10. ``PagedTerrain`` streaming: a 128 m ``grid_mesh`` terrain in 256 pages
   of 8 m, 32 pool slots, page caches on disk, the prefetch thread on,
   under a 64-body convoy at 8 m/s for 240 steps with ``update()`` each
   frame: no centre below the surface, pages loaded and unloaded, none
   refused, at most 32 resident; the pool table bit-equal to the CPU
   path's for the same tile writes.
11. The networked path (``networked_path``) on ``mixed_pile(10_000)``
   with a ``"steer"`` user component and 256 spare slots, landed by 120
   steps: the world's checkpoint resumed on the card steps 30 steps
   bit-equal to the live world, and the same bytes loaded on the CPU
   equal the card's resumed state leaf for leaf; a ``NetworkServer`` on
   the pile serves a spectator (every entity, its transforms bit-equal to
   the server's last delivered snapshot) and a player (a sphere it
   creates, a ``"steer"`` input each frame, a 100 ms link, snapshots
   replayed on the background worker, its world stepped each frame) for
   120 frames over byte channels that lose 10% of unreliable packets;
   ``AsyncSimulation`` steps the pile for 2 s under 64 impulses and 4,096
   queued raycasts; ``Presentation`` renders 30 frames at 30 fps. Every
   thread alive and on the main thread's stream, every world's counters
   zero; K1-K4 launched, K5 not.
12. Float64 and the sweep broadphase. 12a: phase 3's path under
   ``torch.set_default_dtype(torch.float64)`` (the port's f64 mode), 120
   steps and ``suggest_max_pairs`` once, launch counts read as in phase 3:
   K1-K5's double entries (``*_f64``) launched, the float entries not at
   all; every state leaf float64, every counter int32 and zero, phase 3's
   pile checks; steps/s beside phase 3's. 12b: the double entries against
   their plain float64 versions on phase 2's random inputs at f64 and on a
   real step of that pile (K1-K3b max abs error 0, the fused iterations
   and ``segment_sum`` bit-equal as in phase 2, K4 equal on every pair
   with its pre-pass and order, K5's counts equal, its edge cases too),
   timed L2-cold against bounds at the float64 rate. 12c: phase 5 at
   float64. 12d: the landed 10k pile of phase 3 (float32) stepped 60 steps
   under ``broadphase_mode="sweep"`` and under ``"dense"`` from the same
   state, the pair keys equal at every step, then the two broadphases
   alone timed on that state; a 30-step drop of ``mixed_pile(65_531)``
   (65,536 slots, the pair-key limit) under "sweep", its keys equal to
   ``find_pairs``' at every step that grew nothing, both broadphases timed.
13. The step sharded over a mesh (``edyn_tpu_torch.parallel``). 13a:
   phase 3's 10k pile (``max_pairs`` 208,128 from the drop) stepped 120
   times over 4 shards on one card (over the cards, in turn, where there
   are several), twice: the second run with every shard's part of each
   body-space sum a hop of its own (``hop_each_shard``, the path of shards
   on distinct cards); each run equal in every leaf to the unsharded step
   from the same start (else the first differing step and leaves), every
   shard's device launching K1, K2, K3a, K3b and K4 and none K5 (counts by
   device and shard, ``cuda_lib.DEVICE_LAUNCHES``), no overflow, phase 3's
   pile checks; the fused K3b held as in phase 2 on every shard's rows of
   a step from the end state; the ordered chain against one ``index_sum``
   on random rows.
   13b: the three cases of the JAX package's ``tests/test_sharding.py``
   at their sizes on 8 shards, equal to the unsharded step at every step,
   the asleep case solved at the ladder's narrow tier (quantum 256 x 8).
   13c: the landed pile's ms/step unsharded and at 1, 2 and 4 shards in
   turns, the gathers' and chains' ms, kernels a step, peak memory per
   device, on 13a's end state (pickled by 13a's process). ``--phases
   13`` runs 13a, 13b and 13c in order in one process.
14. The merge kernel (``csrc/merge_kernel.cu``): the share of rows where
   PyTorch's own sums on the card add in the orders the kernel repeats
   (raises below all of them); bit-equal to the plain merge
   (``merge_kernel.merge_fresh_plain``) on every output leaf, on the
   crafted tables of ``collision/kernels/merge_cases.py`` at float32 and
   float64 (each case's rule shown in the kernel's output too) and on the
   65k drop of ``portbench/configs/pile65k.json`` at its ``max_pairs``
   (sweep after one dense step, 120 steps), timed there L2-cold against
   its byte bound (``merge_slot_bytes``) beside the plain merge's one
   call. Phases 3, 12a, 9 and 13a hold it the same way on every 30th step
   of their own runs (``MergeWatch``: the 10k drop, its float64 twin, the
   mostly-asleep steps, every shard of 13a's first run), check one launch
   a step (a shard a step in 13a) and, but 13a, time it on their last
   step's inputs. A leaf that differs stops the run.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet): device memory rate, and the float32
# and float64 rates outside the tensor cores. The bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the rate
# of its scalar type.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FP64_FLOPS_PER_S = 34e12
L2_BYTES = 50 * 2**20

# Per row: table rows each kernel reads (see solver_kernels.ROWS_READ), the
# other float inputs and outputs it moves, and its float operations
# (multiplies, adds, compares, sqrt and divide each counted as one).
KERNELS = {
    # name: (pallas_call line of the TPU kernel, other floats in, out, flops)
    "solve_iteration": ("edyn_tpu/dynamics/pallas_solver.py:262",
                        6 + 12, 6 + 12, None),
    "ngs_iteration": ("edyn_tpu/dynamics/pallas_solver.py:441",
                      12, 12 + 1, 60),
    "restitution_iteration": ("edyn_tpu/dynamics/pallas_solver.py:342",
                              2 + 3 + 12, 3 + 12, 150),
    "relvel": ("edyn_tpu/dynamics/pallas_solver.py:384", 12, 1, 23),
}
FLOPS_K1 = {False: 150, True: 250}  # without / with the spin-roll rows
SOURCE = "edyn_tpu_torch/csrc/solver_kernels.cu"
SOLVER_KERNELS = {"solve_iteration": "vel_kernel",
                  "ngs_iteration": "ngs_kernel",
                  "restitution_iteration": "rest_kernel",
                  "relvel": "relvel_kernel"}
SOURCES = ("solver_kernels", "unified_kernel", "overlap_count",
           "merge_kernel")
K4 = dict(name="collide_support",
          source="edyn_tpu_torch/csrc/unified_kernel.cu",
          replaces="edyn_tpu/collision/kernels/pallas_unified.py:568")
# K4's wrapper: three steps (each counted in unified_kernel.LAUNCHES), six
# kernels of its source
K4_STEPS = {"unified_features": ("features_kernel", "class_ids_kernel"),
            "pair_order": ("pair_bins_kernel", "bin_offsets_kernel",
                           "pair_place_kernel"),
            "collide_support": ("unified_kernel",)}
K5 = dict(name="count_overlaps",
          source="edyn_tpu_torch/csrc/overlap_count.cu",
          replaces="edyn_tpu/ops/overlap_count.py:85")
K5_OPS_PER_PAIR = 8   # 6 interval compares, the validity test, the count
TOL = 1e-5  # |kernel - plain| <= TOL * (1 + |plain|): same rounding, f32
THRESHOLD = 0.01   # Settings.collision_threshold
K4_PAIRS = 190_000  # random pairs: about the landing pile's live count
# the main path: the bench's pile, stepped until most of it has landed
N_BODIES = 10_000
STEPS = 120


def log(*a):
    print(*a, flush=True)


_START = time.perf_counter()


def mark(phase: int):
    """Log the script's clock at the end of a phase."""
    log(f"[clock] phase {phase} ended at {time.perf_counter() - _START:.1f} s")


# the joint path: 768 ragdolls (13 bodies, 20 joints each) on a 16 x 16
# grid in 3 layers, about the main path's body count
N_RAGDOLLS = 768


def ragdoll_pile(pkg, n_ragdolls: int = N_RAGDOLLS, seed: int = 0,
                 layers: int = 3):
    """A pile of ragdolls dropped into a plane-walled bin, built through a
    package's public names (``edyn_tpu_torch`` or ``edyn_tpu``): the floor
    and 4 inward walls at +-9 m with ``mixed_pile``'s plane material, and
    ``n_ragdolls`` of ``make_ragdoll(RagdollDef(position=...))`` on a square
    grid at a 1.0 m pitch, ``layers`` layers whose bases are 2.0 m apart
    from y = 0.3 m, each base jittered by up to 5 cm from ``seed``.
    Returns (builder, ragdolls)."""
    import importlib
    import numpy as np
    rag = importlib.import_module(pkg.__name__ + ".utils.ragdoll")
    rng = np.random.default_rng(seed)
    b = pkg.WorldBuilder()
    mat = pkg.Material(friction=0.6)
    b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, shape=pkg.PlaneShape((0, 1, 0), 0.0),
        material=mat))
    for nrm in ((1, 0, 0), (-1, 0, 0), (0, 0, 1), (0, 0, -1)):
        b.make_rigidbody(pkg.RigidBodyDef(
            kind=pkg.KIND_STATIC, shape=pkg.PlaneShape(nrm, -9.0),
            material=mat))
    per_layer = -(-n_ragdolls // layers)
    side = int(np.ceil(np.sqrt(per_layer)))
    out = []
    for i in range(n_ragdolls):
        layer, cell = divmod(i, per_layer)
        iz, ix = divmod(cell, side)
        j = rng.uniform(-0.05, 0.05, 3)
        pos = ((ix - (side - 1) / 2) * 1.0 + j[0], 0.3 + 2.0 * layer + j[1],
               (iz - (side - 1) / 2) * 1.0 + j[2])
        out.append(rag.make_ragdoll(b, rag.RagdollDef(position=pos)))
    return b, out


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_inputs(C: int, Rp: int, N: int, seed: int, dev):
    """Random kernel inputs with each table row in its natural range."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g, device=dev)
    t = torch.randn((C, Rp), generator=g, device=dev)
    for r in (45, 46, 47):                      # effective masses
        t[r] = u(Rp)
    t[53] = u(Rp)                               # friction
    t[54] = torch.where(u(Rp) > 0.5, u(Rp) * 10, torch.full((Rp,), 1e18,
                                                            device=dev))
    t[55] = (u(Rp) > 0.25).float()              # valid
    t[56] = u(Rp)                               # restitution
    t[63] = t[63] * 0.01                        # base_dist
    t[64] = t[55] * (u(Rp) > 0.2).float()       # ngs_valid: valid, not soft
    if C > 65:
        for r in (65 + 24, 65 + 25, 65 + 26):   # spin/roll eff. masses
            t[r] = u(Rp)
        t[65 + 30] = u(Rp) * 0.1                # spin friction
        t[65 + 31] = u(Rp) * 0.1                # roll friction
    ab = torch.randint(0, N, (2 * Rp,), generator=g, device=dev)
    vel_t = torch.randn((6, N), generator=g, device=dev) * 0.1
    return dict(
        tbl=t.contiguous(), imp=u(6, Rp), imp3=u(3, Rp),
        g=vel_t[:, ab].contiguous(),
        dyn=torch.stack([torch.randn((Rp,), generator=g, device=dev),
                         (u(Rp) > 0.3).float()]).contiguous(),
        # the fused iterations' endpoints and [N,6] deltas; every body
        # moves (the random table gives every side a mass)
        ab=ab, vel=vel_t.T.contiguous(),
        moves=torch.ones((N,), dtype=torch.bool, device=dev))


def _events():
    import torch
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def call_ms(fn, reps: int) -> float:
    """Median CUDA-event time of one call as the main path makes it: the
    wrapper's host work (checks, allocation, launch) included."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = _events()
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fns, per_graph: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``per_graph`` calls, cycling through
    ``fns``, captured in a CUDA graph and replayed back to back, so host
    overhead drops out. Median over ``reps`` replays, divided by
    ``per_graph``."""
    import torch
    per_graph = -(-per_graph // len(fns)) * len(fns)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = _events()
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / per_graph)
    return statistics.median(times)


def kernel_calls(inp, with_sr: bool):
    """(kernel wrapper call, plain call) per kernel on one set of inputs."""
    from edyn_tpu_torch.config import CONTACT_POSITION_CORRECTION_RATE
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    from edyn_tpu_torch.dynamics.position import MAX_CORRECTION
    t, g = inp["tbl"], inp["g"]
    rate, mc = float(CONTACT_POSITION_CORRECTION_RATE), float(MAX_CORRECTION)
    return {
        "solve_iteration": (
            lambda: sk.solve_iteration(t, inp["imp"], g, with_sr),
            lambda: sk.solve_iteration_plain(t, inp["imp"], g, with_sr)),
        "ngs_iteration": (lambda: sk.ngs_iteration(t, g, rate, mc),
                          lambda: sk.ngs_iteration_plain(t, g, rate, mc)),
        "restitution_iteration": (
            lambda: sk.restitution_iteration(t, inp["dyn"], inp["imp3"], g),
            lambda: sk.restitution_iteration_plain(t, inp["dyn"],
                                                   inp["imp3"], g)),
        "relvel": (lambda: sk.relvel(t, g), lambda: sk.relvel_plain(t, g)),
    }


def max_err(name, got, want) -> float:
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for a, b in zip(got, want):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: kernel output not finite")
        d = (a - b).abs()
        if bool((d > TOL * (1 + b.abs())).any()):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by {float(d.max())}")
        worst = max(worst, float(d.max()))
    return worst


def check_kernels(inp, with_sr: bool, label: str,
                  exact: bool = False) -> dict:
    """Hold every kernel against its plain version; time both. With
    ``exact`` the two must agree to the bit (max abs error 0), else within
    ``TOL``. The bytes and the operation rate follow the inputs' dtype.

    ``ms`` and ``plain_ms`` are L2-cold: the graph cycles through copies of
    the inputs that together move at least three times the L2's size, so
    every launch reads its inputs from device memory, as the bound assumes.
    ``warm_ms`` replays the kernel on one input set, which stays in L2 when
    it fits."""
    import torch
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    C, Rp = inp["tbl"].shape
    es, rate = inp["tbl"].element_size(), flops_per_s(inp["tbl"].dtype)
    out = {}
    for name, (kern, plain) in kernel_calls(inp, with_sr).items():
        err = max_err(name, kern(), plain())
        if exact and err != 0.0:
            raise AssertionError(f"[{label}] {name} differs from its plain "
                                 f"version by {err}, 0 required")
        torch.cuda.synchronize()
        _, extra_in, n_out, flops = KERNELS[name]
        nbytes = es * Rp * (sk.rows_read(name, with_sr) + extra_in + n_out)
        n_sets = max(2, -(-3 * L2_BYTES // nbytes))
        sets = [inp] + [{k: v.clone() for k, v in inp.items()}
                        for _ in range(n_sets - 1)]
        calls = [kernel_calls(s, with_sr)[name] for s in sets]
        ms = device_ms([k for k, _ in calls])
        plain_ms = device_ms([p for _, p in calls], per_graph=n_sets)
        del sets, calls
        warm_ms = device_ms([kern])
        per_call = call_ms(kern, 20)
        ops = Rp * (FLOPS_K1[with_sr] if flops is None else flops)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         warm_ms=warm_ms, call_ms=per_call,
                         bound_ms=1e3 * max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", bytes=nbytes, C=C, Rp=Rp,
                         dtype=str(inp["tbl"].dtype))
        log(f"[{label}] {name}: {inp['tbl'].dtype} C={C} Rp={Rp} "
            f"max_abs_err={err:.3g} "
            f"({'0 required' if exact else f'tol {TOL} x (1+|plain|)'}); "
            f"device {ms * 1e3:.2f} us L2-cold "
            f"({n_sets} input sets), {warm_ms * 1e3:.2f} us L2-warm; plain "
            f"{plain_ms * 1e3:.2f} us; bound "
            f"{out[name]['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.2f} MB); "
            f"one call with its host work {per_call * 1e3:.1f} us")
    return out


# The card's fused iterations: K1, K3a and K2 with their endpoint
# gather inside, and the segment sum that adds their terms per body.
# name: (pallas_call line of the TPU kernel, CUDA kernel, the unfused
# kernel it is held to)
FUSED = {
    "solve_iteration_fused": ("edyn_tpu/dynamics/pallas_solver.py:262",
                              "vel_fused_kernel", "solve_iteration"),
    "restitution_iteration_fused": ("edyn_tpu/dynamics/pallas_solver.py:342",
                                    "rest_fused_kernel",
                                    "restitution_iteration"),
    "ngs_iteration_fused": ("edyn_tpu/dynamics/pallas_solver.py:441",
                            "ngs_fused_kernel", "ngs_iteration"),
    "segment_sum": ("none (the XLA scatter-add around "
                    "edyn_tpu/dynamics/pallas_solver.py:262, :342 and :441)",
                    "segment_sum_kernel", None),
    "relvel_fused": ("edyn_tpu/dynamics/pallas_solver.py:384",
                     "relvel_fused_kernel", "relvel"),
}
# the fused K3b's float operations a row: relvel_kernel's 23, then the
# pass's glue (negate, add, multiply, three compares, two ands)
RELVEL_FUSED_FLOPS = 31


def bits_equal(a, b) -> bool:
    """Equal to the bit (the sign of a zero too)."""
    import torch
    it = torch.int64 if a.dtype == torch.float64 else torch.int32
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(it), b.contiguous().view(it)))


def profiled_us(fn, reps: int = 10):
    """Device time (us) of all the kernels one call of ``fn`` launches,
    from ``torch.profiler`` over ``reps`` calls (device events only); None
    where the profiler recorded no device event (not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                total += getattr(e, attr)
                break
    return total / reps if total else None


def unfused_pass(tbl, vel_t, ab_p):
    """One restitution outer pass's rows as the step ran them on the card
    before K3b moved onto the plan: the [6,N] velocities gathered into
    [6,2Rp], the unfused K3b, the pass's glue in PyTorch, ``any(active)``
    read on the host. Returns (dyn [2,Rp], whether a row is active)."""
    import torch
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    valid, restit = tbl[55:56] > 0.5, tbl[56:57]
    relv = sk.relvel(tbl, vel_t[:, ab_p])
    active = valid & (relv < sk.RELVEL_THRESHOLD) & (restit > 0)
    dyn = torch.cat([-relv * (1.0 + restit), active.to(tbl.dtype)], dim=0)
    return dyn, bool(torch.any(active))


def fused_pass(tbl, d, t, plan, out=None):
    """The same pass as the planned step runs it on one shard's rows: the
    fused K3b on the [N,8] velocities ``d`` by the shard's targets ``t``
    with the next generation of their ``plan``, then the shard's flag read
    on the host. Returns (dyn, whether a row is active)."""
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    gen = plan.next_generation()
    dyn = sk.relvel_fused(tbl, d, t.ab, t.flag, gen, out)
    return dyn, gen in t.flag.tolist()


def hold_k3b(tbl, vel, t, plan, label: str) -> bool:
    """``relvel_fused`` on one shard's rows (its table ``tbl``, targets
    ``t`` of ``plan``, the [N,6] velocities ``vel``) against the unfused
    pass and against its plain version: dyn and the flag bit-equal; with the
    velocities zero, no row active and no flag raised. Returns whether a
    row was active."""
    import torch
    from edyn_tpu_torch.dynamics import scatter
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    seen = []
    for case, v in (("", vel), (", zero velocities", torch.zeros_like(vel))):
        d = scatter.body_table(v)
        old, old_any = unfused_pass(tbl, v.T.contiguous(), t.ab.long())
        new, new_any = fused_pass(tbl, d, t, plan)
        flag = torch.zeros_like(t.flag)
        plain = sk.relvel_fused_plain(tbl, d, t.ab, flag, 1)
        torch.cuda.synchronize()
        for what, a, b in (("the unfused pass", new, old),
                           ("its plain version", plain, new)):
            if not bits_equal(a, b):
                diff = float((a - b).abs().max())
                raise AssertionError(f"[{label}{case}] relvel_fused differs "
                                     f"from {what} (max abs {diff}), "
                                     "bit-equal required")
        if not old_any == new_any == (int(flag) == 1):
            raise AssertionError(f"[{label}{case}] relvel_fused's flag "
                                 f"{new_any}, unfused any(active) {old_any},"
                                 f" plain flag {int(flag)}")
        seen.append(new_any)
    if seen[1]:
        raise AssertionError(f"[{label}] relvel_fused raised its flag with "
                             "the velocities zero")
    return seen[0]


def check_fused(inp, with_sr: bool, label: str,
                stress: bool = False) -> dict:
    """The fused K1, K3a and K2 iterations, the fused K3b and
    ``segment_sum`` on one input set (``inp``: a packed table, impulses,
    ``dyn``, the endpoints ``ab`` [2Rp], the body velocities ``vel`` [N,6]
    as the deltas, the bodies that can move ``moves``), through the step's
    own functions over one shard:

    - one velocity iteration by the fused path
      (``solver.solve_contacts_planned``) and by the unfused one
      (``solver.solve_contacts_sharded``: gather, K1, ``index_sum``), one
      restitution inner iteration and one position iteration (K2, the
      velocities taken as position deltas) each way: impulses (K2: errors)
      and deltas equal to the bit; also the fused path's plain versions
      (``*_fused_plain``, ``segment_sum_plain``) on the card, to the bit;
    - one restitution outer pass by the fused K3b and by the unfused path
      (gather, K3b, the glue, ``any``) and the fused K3b's plain version
      (``hold_k3b``): dyn and the flag equal to the bit, and no flag with
      the velocities zero;
    - ``segment_sum`` against ``solver.index_sum`` (``index_put_`` with
      ``accumulate``) on the same terms, to the bit; with ``stress``, also
      on ``segment_stress``'s long run beside empty ones;
    - each new kernel's device time, L2-cold (CUDA-graph replays cycling
      through input copies that together exceed three times the L2), its
      plain version's and, for ``segment_sum``, ``index_sum``'s
      (``library_ms``), each as one call with its host work (CUDA events;
      the plain versions sync with the host); and the per-iteration time of
      both paths (K3b: one outer pass, in turns), one call with its host
      work and, from the profiler, the device time of all its kernels.

    Bounds: bytes from device memory over its rate (the table rows the
    kernel reads, impulses in and out, the int32 endpoints and positions,
    the live terms' six components out, the [N,6] deltas once); the
    endpoint loads by index hit L2 and are not counted; the fused K3b
    writes dyn [2,Rp] and no terms. For the segment sum: the live terms in,
    the offsets, x in and out."""
    import torch
    from edyn_tpu_torch.config import CONTACT_POSITION_CORRECTION_RATE
    from edyn_tpu_torch.dynamics import scatter
    from edyn_tpu_torch.dynamics import solver
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    from edyn_tpu_torch.dynamics.position import MAX_CORRECTION
    from edyn_tpu_torch.parallel.collectives import Mesh
    tbl, imp, imp3, vel = inp["tbl"], inp["imp"], inp["imp3"], inp["vel"]
    C, Rp = tbl.shape
    N, dt = vel.shape[0], tbl.dtype
    es, rate = tbl.element_size(), flops_per_s(dt)
    # active rows are valid rows, as solve_restitution_sharded makes them
    dyn = torch.stack([inp["dyn"][0], inp["dyn"][1] * (tbl[55] > 0.5)])
    mesh = Mesh((tbl.device,))
    pack = solver.ShardPack.of_table(tbl, inp["ab"])
    plan = scatter.ScatterPlan.build([pack], inp["moves"], mesh)
    t, h = plan.shards[0], plan.hops[0]
    kept = int(h.offsets[-1])
    d0 = scatter.body_table(vel)
    ngs = (float(CONTACT_POSITION_CORRECTION_RATE), float(MAX_CORRECTION))

    def plain_iteration(kern):
        ta, d = torch.zeros_like(t.terms_a), d0.clone()
        if kern == "K1":
            out = sk.solve_iteration_fused_plain(tbl, imp, d, t.ab, t.pos, ta,
                                                 ta, with_sr)
        elif kern == "K2":
            out = sk.ngs_iteration_fused_plain(tbl, d, t.ab, t.pos, ta, ta,
                                               *ngs)
        else:
            out = sk.restitution_iteration_fused_plain(tbl, dyn, imp3, d,
                                                       t.ab, t.pos, ta, ta)
        return out, sk.segment_sum_plain(ta, h.offsets, x=d), ta

    def unfused(kern):
        x_t = vel.T.contiguous()
        if kern == "K1":
            (o,), x = solver.solve_contacts_sharded([pack], [imp], x_t,
                                                    with_sr, mesh)
            return o, x
        g = x_t[:, pack.ab_p]
        if kern == "K2":
            # as position.solve_positions_sharded's unfused iteration
            upd, o = sk.ngs_iteration(tbl, g, *ngs)
            return o, solver.chain_upd_t(x_t, [pack], [upd], mesh)
        o, upd = sk.restitution_iteration(tbl, dyn, imp3, g)
        return o, solver.scatter_upd_t(x_t, pack.ab_p, upd)

    def fused(kern, d):
        if kern == "K1":
            (o,), d = solver.solve_contacts_planned([pack], [imp], d, with_sr,
                                                    mesh, plan)
            return o, d
        if kern == "K2":
            o = sk.ngs_iteration_fused(tbl, d, t.ab, t.pos, t.terms_a,
                                       t.terms_b, *ngs)
        else:
            o = sk.restitution_iteration_fused(tbl, dyn, imp3, d, t.ab,
                                               t.pos, t.terms_a, t.terms_b)
        return o, plan.add(d, mesh)

    out, iteration = {}, {}
    for kern, name in (("K1", "solve_iteration_fused"),
                       ("K3a", "restitution_iteration_fused"),
                       ("K2", "ngs_iteration_fused")):
        o_old, x_old = unfused(kern)
        o_new, d_new = fused(kern, d0.clone())
        terms = t.terms_a.clone()
        o_pl, d_pl, terms_pl = plain_iteration(kern)
        torch.cuda.synchronize()
        for what, a, b in (("impulses", o_new, o_old),
                           ("deltas", d_new[:, :6], x_old.T),
                           ("plain impulses", o_pl, o_new),
                           ("plain deltas", d_pl, d_new),
                           ("plain terms", terms_pl, terms)):
            if not bits_equal(a, b):
                diff = float((a - b).abs().max())
                raise AssertionError(f"[{label}] {name}: {what} differ from "
                                     f"the {'plain' if 'plain' in what else 'unfused'} "
                                     f"path (max abs {diff}), bit-equal "
                                     "required")
        # K2 writes zero terms where no row penetrates (a settled pile)
        moves = (kept if kern != "K2" else bool((terms[:, :6] != 0).any()))
        if moves and not float((d_new[:, :6] - vel).abs().max()) > 0:
            raise AssertionError(f"[{label}] {name} moved no body")
        # segment_sum alone against index_sum on this iteration's terms
        if kern == "K1":
            g = vel.T.contiguous()[:, pack.ab_p]
            _, upd = sk.solve_iteration(tbl, imp, g, with_sr)
            src = torch.cat([upd[:6], upd[6:]], dim=1).T.contiguous()
            lib = solver.index_sum(vel, pack.ab_p, src)
            seg = sk.segment_sum(terms, h.offsets, x=d0.clone())
            if not bits_equal(seg[:, :6], lib):
                raise AssertionError(f"[{label}] segment_sum differs from "
                                     "index_sum on the same terms")
            seg_terms = terms
        iteration[kern] = dict(
            old_call_ms=call_ms(lambda: unfused(kern), 20),
            new_call_ms=call_ms(lambda: fused(kern, d0.clone()), 20),
            old_device_us=profiled_us(lambda: unfused(kern)),
            new_device_us=profiled_us(lambda: fused(kern, d0.clone())),
            new_device_timed_by="torch.profiler")
        if iteration[kern]["new_device_us"] is None:
            # no device event recorded: the fused path's launches replayed
            # in a CUDA graph, timed with CUDA events
            iteration[kern].update(
                new_device_us=1e3 * device_ms([lambda: fused(kern,
                                                            d0.clone())]),
                new_device_timed_by="CUDA graph (CUDA events)")

    # K3b: one restitution outer pass each way, then each timed in turns
    any_active = hold_k3b(tbl, vel, t, plan, label)
    vel_t, dyn_buf = vel.T.contiguous(), torch.empty_like(dyn)
    passes = {"old": lambda: unfused_pass(tbl, vel_t, pack.ab_p),
              "new": lambda: fused_pass(tbl, d0, t, plan, dyn_buf)}
    turns = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        turns[which].append(call_ms(passes[which], 20))
    iteration["K3b"] = dict(
        old_call_ms=statistics.median(turns["old"]),
        new_call_ms=statistics.median(turns["new"]), call_turns=turns,
        old_device_us=profiled_us(passes["old"]),
        new_device_us=profiled_us(passes["new"]),
        new_device_timed_by="torch.profiler", any_active=any_active)
    if iteration["K3b"]["new_device_us"] is None:
        # the kernel alone (the flag's host read cannot be captured)
        gen = plan.next_generation()
        iteration["K3b"].update(
            new_device_us=1e3 * device_ms([lambda: sk.relvel_fused(
                tbl, d0, t.ab, t.flag, gen, dyn_buf)]),
            new_device_timed_by="CUDA graph of the kernel (CUDA events)")

    if stress:
        out["segment_stress"] = segment_stress(N, dt, tbl.device, label)

    # each new kernel alone, L2-cold
    idx_bytes = 4 * 2 * Rp * 2   # ab and pos, int32
    body_bytes = es * 6 * N
    term_bytes = es * 6 * kept
    k1_rows = sk.rows_read("solve_iteration", with_sr)
    k3_rows = sk.rows_read("restitution_iteration")
    k2_rows = sk.rows_read("ngs_iteration")
    work = {
        "solve_iteration_fused": (
            es * Rp * (k1_rows + 12) + idx_bytes + term_bytes + body_bytes,
            Rp * FLOPS_K1[with_sr]),
        "restitution_iteration_fused": (
            es * Rp * (k3_rows + 2 + 6) + idx_bytes + term_bytes + body_bytes,
            Rp * KERNELS["restitution_iteration"][3]),
        "ngs_iteration_fused": (
            es * Rp * (k2_rows + 1) + idx_bytes + term_bytes + body_bytes,
            Rp * KERNELS["ngs_iteration"][3]),
        "segment_sum": (term_bytes + 4 * (N + 1) + 2 * body_bytes, 6 * kept),
        "relvel_fused": (
            es * Rp * (sk.rows_read("relvel_fused") + 2) + 4 * 2 * Rp
            + body_bytes, Rp * RELVEL_FUSED_FLOPS),
    }
    k3b_gen = plan.next_generation()

    def kernel_fn(name, s):
        if name == "solve_iteration_fused":
            return lambda: sk.solve_iteration_fused(
                s["tbl"], s["imp"], s["d"], t.ab, t.pos, s["terms"],
                s["terms"], with_sr)
        if name == "restitution_iteration_fused":
            return lambda: sk.restitution_iteration_fused(
                s["tbl"], dyn, imp3, s["d"], t.ab, t.pos, s["terms"],
                s["terms"])
        if name == "ngs_iteration_fused":
            return lambda: sk.ngs_iteration_fused(
                s["tbl"], s["d"], t.ab, t.pos, s["terms"], s["terms"], *ngs)
        if name == "relvel_fused":
            return lambda: sk.relvel_fused(s["tbl"], s["d"], t.ab, t.flag,
                                           k3b_gen)
        return lambda: sk.segment_sum(s["terms"], h.offsets, x=s["d"])

    def plain_fn(name):
        d, ta = d0.clone(), torch.zeros_like(t.terms_a)
        if name == "solve_iteration_fused":
            return lambda: sk.solve_iteration_fused_plain(
                tbl, imp, d, t.ab, t.pos, ta, ta, with_sr)
        if name == "restitution_iteration_fused":
            return lambda: sk.restitution_iteration_fused_plain(
                tbl, dyn, imp3, d, t.ab, t.pos, ta, ta)
        if name == "ngs_iteration_fused":
            return lambda: sk.ngs_iteration_fused_plain(
                tbl, d, t.ab, t.pos, ta, ta, *ngs)
        if name == "relvel_fused":
            flag = torch.zeros_like(t.flag)
            return lambda: sk.relvel_fused_plain(tbl, d, t.ab, flag, k3b_gen)
        return lambda: sk.segment_sum_plain(seg_terms, h.offsets, x=d)

    us = lambda x: "not measured" if x is None else f"{x:.2f} us"
    for name, (nbytes, ops) in work.items():
        # the sets' bytes this kernel moves come to three times the L2
        n_sets = max(2, -(-3 * L2_BYTES // nbytes))
        sets = [dict(tbl=tbl.clone() if name != "segment_sum" else tbl,
                     imp=imp.clone(), d=d0.clone(),
                     terms=seg_terms.clone()) for _ in range(n_sets)]
        ms = device_ms([kernel_fn(name, s) for s in sets])
        # one input set replayed: for segment_sum the step's case, whose
        # terms the fused kernel has just written into L2
        warm_ms = device_ms([kernel_fn(name, sets[0])])
        if name == "segment_sum":
            # yardsticks in the same protocol: the kernel with no term to
            # add (its fixed cost), and a copy of the planned terms
            none = torch.zeros_like(h.offsets)
            floor = dict(no_terms_ms=device_ms([
                lambda s=s: sk.segment_sum(s["terms"], none, x=s["d"])
                for s in sets]))
            copies = [(s["terms"][:kept], torch.empty_like(s["terms"][:kept]))
                      for s in sets]
            floor["copy_terms_ms"] = device_ms([
                lambda a=a, b=b: b.copy_(a) for a, b in copies]) \
                if kept else None
            del copies
        del sets
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
        r = dict(ms=ms, warm_ms=warm_ms, plain_ms=call_ms(plain_fn(name), 5),
                 plain_timed_by="one call with its host work (CUDA events)",
                 call_ms=call_ms(kernel_fn(name, dict(
                     tbl=tbl, imp=imp, d=d0.clone(), terms=seg_terms.clone())),
                     20),
                 bound_ms=1e3 * max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bytes=nbytes, kept_terms=kept, C=C, Rp=Rp, N=N,
                 dtype=str(dt), max_abs_err=0.0, library_ms=None)
        if name == "segment_sum":
            r.update(floor)
            r["library_ms"] = call_ms(
                lambda: solver.index_sum(vel, pack.ab_p, src), 20)
            r["library"] = ("solver.index_sum (index_put_ with accumulate), "
                            "one call with its host work (CUDA events)")
        else:
            kern = {"solve_iteration_fused": "K1", "ngs_iteration_fused": "K2",
                    "restitution_iteration_fused": "K3a",
                    "relvel_fused": "K3b"}[name]
            r["iteration"] = iteration[kern]
        out[name] = r
        copy_us = r.get("copy_terms_ms") and 1e3 * r["copy_terms_ms"]
        log(f"[{label}] {name}: {dt} C={C} Rp={Rp} N={N}, {kept} live "
            f"terms planned; bit-equal to the unfused path and to its plain "
            f"version; device {ms * 1e3:.2f} us L2-cold ({n_sets} input "
            f"sets), {warm_ms * 1e3:.2f} us L2-warm; one call "
            f"{r['call_ms'] * 1e3:.1f} us; plain (one call) "
            f"{r['plain_ms'] * 1e3:.1f} us; bound {r['bound_ms'] * 1e3:.2f} "
            f"us ({nbytes / 1e6:.2f} MB)"
            + (f"; index_sum (one call) {r['library_ms'] * 1e3:.1f} us; "
               f"with no term {r['no_terms_ms'] * 1e3:.2f} us, a copy of the "
               f"planned terms {us(copy_us)} (L2-cold)"
               if name == "segment_sum" else ""))
    for kern, it in iteration.items():
        old, new = (("gather, kernel, the glue, any", "kernel, flag read")
                    if kern == "K3b" else
                    ("gather, kernel, index_sum", "kernel, segment_sum"))
        log(f"[{label}] one {kern} {'pass' if kern == 'K3b' else 'iteration'}"
            f": unfused ({old}) {it['old_call_ms'] * 1e3:.1f} us a call, "
            f"{us(it['old_device_us'])} on the device; fused ({new}) "
            f"{it['new_call_ms'] * 1e3:.1f} us a call, "
            f"{us(it['new_device_us'])} on the device")
    return out


# segment_stress's long run: 12 of segment_sum_kernel's shared-memory stages
# in float (512 terms each), 24 in double
STRESS_RUN = 6_000


def segment_stress(n: int, dtype, dev, label: str) -> dict:
    """``segment_sum`` where one movable body has a run of STRESS_RUN terms
    (the kernel streams it through its double-buffered stages), beside a
    body with 2 terms before it and one with 3 after it in the same block
    of bodies, every other run empty; a fifth of the terms zero, some with
    a -0 component. With x: bit-equal to ``segment_sum_plain`` and to
    ``solver.index_sum``; with a start value (a chain hop): bit-equal to
    ``segment_sum_plain``. Also the kernel's time on it (L2-warm)."""
    import torch
    from edyn_tpu_torch.dynamics import solver
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    g = torch.Generator(device=dev).manual_seed(11)
    rand = lambda *shape: torch.randn(shape, generator=g, device=dev,
                                      dtype=dtype)
    b = 32 * (n // 64) + 5
    deg = torch.zeros((n,), dtype=torch.long, device=dev)
    deg[b - 1], deg[b], deg[b + 1] = 2, STRESS_RUN, 3
    off = torch.cat([deg.new_zeros(1), deg.cumsum(0)]).to(torch.int32)
    E = int(off[-1])
    terms = rand(E, 8)
    terms[:, 6:] = 0.0
    terms[torch.rand(E, generator=g, device=dev) < 0.2] = 0.0
    terms[torch.rand(E, generator=g, device=dev) < 0.05, 2] = -0.0
    x, start = rand(n, 8), rand(n, 8)
    x[:, 6:] = 0.0
    start[:, 6:] = 0.0
    start[torch.rand(n, generator=g, device=dev) < 0.3] = 0.0
    target = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    got = sk.segment_sum(terms, off, x=x.clone())
    lib = solver.index_sum(x[:, :6].contiguous(), target,
                           terms[:, :6].contiguous())
    for what, a, want in (
            ("plain", got, sk.segment_sum_plain(terms, off, x=x.clone())),
            ("index_sum", got[:, :6], lib),
            ("plain, start", sk.segment_sum(terms, off, start=start),
             sk.segment_sum_plain(terms, off, start=start))):
        if not bits_equal(a, want):
            raise AssertionError(f"[{label}] segment_sum on a run of "
                                 f"{STRESS_RUN} terms differs from {what}")
    xs = x.clone()
    ms = device_ms([lambda: sk.segment_sum(terms, off, x=xs)])
    log(f"[{label}] segment_sum, a run of {STRESS_RUN} terms beside runs of "
        f"2 and 3 and {n - 3} empty ones ({dtype}): bit-equal to its plain "
        f"version and to index_sum, with a start value to its plain "
        f"version; device {ms * 1e3:.2f} us L2-warm")
    return dict(run=STRESS_RUN, terms=E, n=n, ms=ms, dtype=str(dtype))


def fused_entry(name: str, r: dict, others: dict, launches: dict,
                scalar: str = "float", unfused: dict = None) -> dict:
    """The kernels line's entry of a fused iteration's kernel or of the
    segment sum (``check_fused``): ``r`` its results at the main path's
    shapes (the landed pile's real step), ``others`` more of them by label
    (random inputs, the mostly-asleep width), ``launches`` its counts by
    path, ``unfused`` the unfused kernel's ``check_kernels`` results by
    label (the card's reference, off the main path)."""
    replaces, kernel, unf = FUSED[name]
    held = ("bit-equal to its plain version and to the unfused path "
            f"(gather, {unf}, index_sum)" if unf else
            "bit-equal to its plain version and to solver.index_sum")
    if name == "relvel_fused":
        held = ("dyn bit-equal to its plain version's and to the unfused "
                "pass's (gather, relvel, the glue), its flag to their "
                "any(active)")
    e = dict(name=name if scalar == "float" else f"{name}_f64",
             route="cuda", source=SOURCE, replaces=replaces, **launches,
             max_abs_err=r["max_abs_err"], tol=held, ms=r["ms"],
             plain_ms=r["plain_ms"], plain_timed_by=r["plain_timed_by"],
             bound_ms=r["bound_ms"], bound_us=r["bound_ms"] * 1e3,
             bound_by=r["bound_by"],
             bound_counts="device-memory bytes; the endpoint loads by index "
                          "hit L2 and are not counted",
             library_ms=r["library_ms"], warm_ms=r["warm_ms"],
             call_ms=r["call_ms"], C=r["C"],
             Rp=r["Rp"], N=r["N"], kept_terms=r["kept_terms"],
             dtype=r["dtype"])
    if "launches" in launches and scalar == "float":
        e["launches_per_step"] = launches["launches"] / STEPS
    if r["library_ms"] is not None:
        e["library"] = r["library"]
    if "iteration" in r:
        e["iteration"] = r["iteration"]
    for k in ("no_terms_ms", "copy_terms_ms"):
        if k in r:
            e[k] = r[k]
    for label, o in others.items():
        e.update({f"{label}_{k}": o[k] for k in (
            "ms", "warm_ms", "plain_ms", "bound_ms", "library_ms", "Rp", "N",
            "kept_terms")})
        if "iteration" in o:
            e[f"{label}_iteration"] = o["iteration"]
    for label, o in (unfused or {}).items():
        if o is not None and unf in o:
            e.update({f"unfused_{label}_{k}": o[unf][k]
                      for k in ("ms", "bound_ms", "Rp")})
    e.update(build_info("solver_kernels", kernel, scalar))
    return e


def count_ops(fn):
    """Elementwise operations ``fn`` runs, counted from the ATen calls it
    makes: the elements each arithmetic, compare, select and logic op
    writes, and the elements each reduction reads. Views, gathers, copies
    and fills are free. Returns (total, {ATen op: count})."""
    from torch.utils._python_dispatch import TorchDispatchMode
    ew = {"add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "sqrt",
          "abs", "clamp", "clamp_min", "clamp_max", "maximum", "minimum",
          "where", "gt", "ge", "lt", "le", "eq", "ne", "bitwise_and",
          "bitwise_or", "bitwise_not", "logical_and", "logical_or",
          "logical_not"}
    red = {"amax", "amin", "argmax", "argmin", "max", "min", "sum", "all",
           "any"}

    by_op = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            n = (out.numel() if name in ew and hasattr(out, "numel")
                 else args[0].numel() if name in red else 0)
            if n:
                by_op[name] = by_op.get(name, 0) + n
            return out

    with Count():
        fn()
    return sum(by_op.values()), by_op


def flops_per_s(dtype) -> float:
    """The card's peak rate for operations on ``dtype``."""
    import torch
    return FP64_FLOPS_PER_S if dtype == torch.float64 else FP32_FLOPS_PER_S


def bound(nbytes: float, ops: float, rate: float = FP32_FLOPS_PER_S) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops)


# Share of the pairs with contact allowed beyond the contract's deepest-depth
# and normal limits. tests/test_pallas_narrowphase.py holds those limits on
# every one of 256 random pairs. On the live pairs of the landed 10k pile
# (115,801 pairs, 36,573 with contact) the JAX package's own kernel and its
# jnp path, run op by op on the CPU on the same inputs, differ beyond them on
# 2-3 pairs (deepest depth up to 0.12 m) exactly as K4 and support_sat do on
# the card (scripts/torch_unified_diff.py, then its --replay). 2e-4 allows
# about twice that count.
CONTRACT_TAIL = 2e-4


def parity_contract(got, pv_ref, d_ref, n_ref, label: str) -> dict:
    """tests/test_pallas_narrowphase.py's contract between a K4 output
    [K, 4, 12] and a reference's point validity, distance and normal:
    contact existence differs on < 1% of pairs, the deepest depth within
    5e-4 and its normal within 2e-3 (on all but CONTRACT_TAIL of the pairs
    with contact), point counts within 1 on > 97% of the shallow pairs."""
    out = contract_stats(got, pv_ref, d_ref, n_ref)
    tail = CONTRACT_TAIL * max(out["with_contact"], 1)
    if not (out["existence_differs"] < 0.01
            and out["deepest_depth_over_5e4"] <= tail
            and out["deepest_normal_over_2e3"] <= tail
            and out["shallow_count_within_1"] > 0.97):
        raise AssertionError(f"[{label}] the parity contract breaks: "
                             f"{out}")
    return out


def contract_stats(got, pv_ref, d_ref, n_ref) -> dict:
    """The measures of ``parity_contract`` (no check)."""
    import torch
    pv_got = got[..., 11] > 0.5
    d_got = torch.where(pv_got, got[..., 10], torch.full_like(d_ref, 1e9))
    d_ref = torch.where(pv_ref, d_ref, torch.full_like(d_ref, 1e9))
    has_got, has_ref = pv_got.any(-1), pv_ref.any(-1)
    exist = float((has_got != has_ref).float().mean())
    both = has_got & has_ref

    def deepest_normal(n, d):
        i = d.argmin(-1)
        return n[torch.arange(len(i), device=n.device), i]
    depth = (d_got.min(-1).values - d_ref.min(-1).values).abs()[both]
    normal = (deepest_normal(got[..., 6:9], d_got)
              - deepest_normal(n_ref, d_ref)).abs().amax(-1)[both]
    shallow = both & (d_ref.min(-1).values > -0.05)
    count_ok = float(((pv_got.sum(-1) - pv_ref.sum(-1)).abs()[shallow] <= 1)
                     .float().mean()) if bool(shallow.any()) else 1.0
    return dict(pairs=len(got), existence_differs=exist,
                with_contact=int(both.sum()),
                deepest_depth_max=float(depth.max()) if len(depth) else 0.0,
                deepest_depth_over_5e4=int((depth > 5e-4).sum()),
                deepest_normal_max=(float(normal.max()) if len(normal)
                                    else 0.0),
                deepest_normal_over_2e3=int((normal > 2e-3).sum()),
                shallow_count_within_1=count_ok)


def build_info(source: str, kernel: str, scalar: str = "float") -> dict:
    """Registers, stack frame and spills of ``kernel`` in ``source``'s build,
    from ``nvcc -Xptxas -v`` (empty when this process did not build it); of
    its ``scalar`` ("float" or "double") instantiation where it is a
    template."""
    import re
    from edyn_tpu_torch.utils import cuda_lib
    info, cur = {}, None
    for line in cuda_lib.BUILD_LOGS.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            continue
        code = "d" if scalar == "double" else "f"
        if cur is None or not re.search(
                f"{len(kernel)}{kernel}(E|I{code}E)", cur):
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            info.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                        spill_load_bytes=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info["registers"] = int(m[1])
    return info


def kernel_times(fns, names, scalar: str = "float") -> dict:
    """Mean device time (us) per launch of each kernel in ``names`` while
    ``fns`` run once each, from ``torch.profiler`` (device events only);
    a template kernel by its ``scalar`` instantiation (``name<float>``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU or not dev_us(e):
            continue
        for n in names:
            if f"{n}(" in e.key or f"{n}<{scalar}>" in e.key:
                out[n] = dev_us(e) / e.count
    return out


def class_ops(tbl, ka, kb, dims, rim: bool, sample: int = 128):
    """Operations of K4's plain version on these pairs, counted by
    ``count_ops`` on a CPU copy of up to ``sample`` pairs of each class
    (pairs of the same real widths and disc flags per side) and scaled to
    the class's size: (live, padded, classes).

    Live is the per-pair kernel's work: ``collide_sides_plain`` with each
    side at its own real widths, without the world rotations (the
    pre-pass's work, counted apart) and without the rim solve of a side
    with no disc (the kernel skips it; its axis is masked). Padded is
    ``collide_support_plain`` at the table's widths, rotations included."""
    import torch
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    tc, a, b = tbl.cpu(), ka.cpu(), kb.cpu()
    feat, code, _ = uk.world_features_plain(tc, dims)
    counts = uk.feature_counts(feat)
    key = code[a].long() * uk.NCODES + code[b].long()
    live = padded = 0.0
    classes = torch.unique(key)
    for k in classes:
        idx = (key == k).nonzero()[:, 0]
        sel = idx[:sample]
        ca, cb = tc[:, a[sel]], tc[:, b[sel]]
        sides = []
        for cols, body in ((ca, a[sel[0]]), (cb, b[sel[0]])):
            real = tuple(int(x) for x in counts[body])
            sides.append(uk.world_side(uk.repack_columns(cols, dims, real),
                                       real))
        A, B = sides
        n_live, _ = count_ops(lambda: uk.collide_sides_plain(
            A, B, THRESHOLD, rim))
        if rim:
            ones = torch.ones_like(A["radius"])
            seed = uk._normalize_or(uk._sub(A["pos"], B["pos"]),
                                    (0 * ones, ones, 0 * ones))
            for C_, D_ in ((A, B), (B, A)):
                if not bool((C_["disc_r"] > 1e-9).any()):
                    n_live -= count_ops(lambda: uk.rim_axis(C_, D_,
                                                            seed))[0]
        n_pad, _ = count_ops(lambda: uk.collide_support_plain(
            ca, cb, dims, THRESHOLD, rim))
        live += n_live * len(idx) / len(sel)
        padded += n_pad * len(idx) / len(sel)
    return live, padded, len(classes)


def check_unified(tbl, ka, kb, dims, rim: bool, label: str,
                  timed: bool) -> dict:
    """K4 against its plain version on the same pairs: equal on every
    output of every pair (as floats: a zero's sign may differ, see
    csrc/unified_kernel.cu; the count of pairs equal bit for bit is
    reported), the pre-pass's table, codes and class numbers bit-equal to
    its plain version, the pair order equal to its plain version. Timed
    when ``timed``: all of the wrapper's launches together, the pre-pass,
    the pair order and the per-pair kernel each alone, and each kernel
    under the profiler, with the live-work and padded bounds; beside them
    the per-pair kernel with the pairs in table order (its output equal to
    the class order's) and a stable ``torch.sort`` of the class bins, the
    library call that would replace the counting sort."""
    import torch
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk

    def calls(t, a, b):
        return (lambda: uk.collide_support_unified(t, a, b, dims, THRESHOLD,
                                                   rim),
                lambda: uk.collide_support_plain(t[:, a], t[:, b], dims,
                                                 THRESHOLD, rim))
    kern, plain = calls(tbl, ka, kb)
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"[{label}] K4 output not finite")
    K = len(ka)
    es, rate = tbl.element_size(), flops_per_s(tbl.dtype)
    ibits = torch.int32 if es == 4 else torch.int64
    equal = (got == want).reshape(K, -1).all(-1)
    bits = (got.view(ibits) == want.view(ibits)).reshape(K, -1).all(-1)
    d = (got - want).abs().reshape(K, -1)
    share = float((d <= TOL * (1 + want.abs().reshape(K, -1))).all(-1)
                  .float().mean())
    if not bool(equal.all()):
        bad = (~equal).nonzero()[:5, 0].tolist()
        raise AssertionError(f"[{label}] K4 differs from its plain version on "
                             f"{int((~equal).sum())} of {K} pairs (first "
                             f"{bad}), max abs {float(d.max())}")
    feat, code, ids = uk.world_features(tbl, dims)
    feat_p, code_p, ids_p = uk.world_features_plain(tbl, dims)
    if not (torch.equal(feat.view(ibits), feat_p.view(ibits))
            and torch.equal(code, code_p) and torch.equal(ids, ids_p)):
        raise AssertionError(f"[{label}] K4's pre-pass differs from its "
                             "plain version")
    perm = uk.pair_order(code, ids, ka, kb)
    if not torch.equal(perm, uk.pair_order_plain(code_p, ids_p, ka, kb)):
        raise AssertionError(f"[{label}] K4's pair order differs from its "
                             "plain version")
    contract = parity_contract(got, want[..., 11] > 0.5, want[..., 10],
                               want[..., 6:9], label)
    bins = uk.pair_bins_plain(code_p, ids_p, ka, kb)
    out = dict(pairs=K, rim_axes=rim, max_abs_err=float(d.max()),
               equal_pairs=int(equal.sum()), bit_equal_pairs=int(bits.sum()),
               within_tol=share, classes=len(torch.unique(bins)),
               valid_points=int((want[..., 11] > 0.5).sum()),
               contract_vs_plain=contract)
    msg = (f"[{label}] K4 {tbl.dtype} rim_axes={rim}: {K} pairs in "
           f"{out['classes']} "
           f"classes, equal to plain on {out['equal_pairs']}, bit-equal on "
           f"{out['bit_equal_pairs']}; pre-pass bit-equal, order equal; "
           f"{out['valid_points']} valid points")
    if timed:
        C, N = tbl.shape
        RS = uk.feature_row(dims)
        nbytes = es * C * N + 16 * K + es * 48 * K
        live, padded, _ = class_ops(tbl, ka, kb, dims, rim)
        tc = tbl.cpu()
        f_ops, _ = count_ops(lambda: uk.world_features_plain(tc, dims))
        o_ops = 4 * K   # two class lookups, a multiply and an add a pair
        n_sets = max(2, -(-3 * L2_BYTES // (nbytes + es * RS * N)))
        sets = []
        for i in range(n_sets):
            t, a, b = ((tbl, ka, kb) if i == 0 else
                       (tbl.clone(), ka.clone(), kb.clone()))
            f, c, n = uk.world_features(t, dims)
            # the class bins as the smallest integers that hold them, for
            # the library's stable sort
            small = torch.uint8 if int(n[uk.NCODES]) <= 16 else torch.int16
            sets.append(dict(t=t, a=a, b=b, f=f, c=c, i=n,
                             p=uk.pair_order(c, n, a, b),
                             table_order=torch.arange(K, device=a.device),
                             key=uk.pair_bins_plain(c, n, a, b).to(small)))
        # the per-pair kernel in table order: what the pair order saves
        s0 = sets[0]
        unsorted = uk.collide_ordered(s0["f"], ka, kb, s0["table_order"],
                                      dims, THRESHOLD, rim)
        if not torch.equal(unsorted, got):
            raise AssertionError(f"[{label}] K4 in table order differs from "
                                 "K4 in class order")
        del unsorted

        def cold(fn, per_graph=20):
            return device_ms([lambda s=s: fn(s) for s in sets], per_graph)

        def whole(s):
            return uk.collide_support_unified(s["t"], s["a"], s["b"], dims,
                                              THRESHOLD, rim)
        out.update(
            ms=cold(whole),
            features_ms=cold(lambda s: uk.world_features(s["t"], dims)),
            order_ms=cold(lambda s: uk.pair_order(s["c"], s["i"], s["a"],
                                                  s["b"])),
            order_library_ms=cold(lambda s: torch.sort(s["key"],
                                                       stable=True)),
            main_ms=cold(lambda s: uk.collide_ordered(
                s["f"], s["a"], s["b"], s["p"], dims, THRESHOLD, rim)),
            table_order_main_ms=cold(lambda s: uk.collide_ordered(
                s["f"], s["a"], s["b"], s["table_order"], dims, THRESHOLD,
                rim)),
            plain_ms=cold(lambda s: calls(s["t"], s["a"], s["b"])[1](),
                          n_sets),
            features_plain_ms=cold(lambda s: uk.world_features_plain(
                s["t"], dims), n_sets),
            order_plain_ms=cold(lambda s: uk.pair_order_plain(
                s["c"], s["i"], s["a"], s["b"]), n_sets),
            warm_ms=device_ms([kern]), call_ms=call_ms(kern, 20),
            kernel_us=kernel_times([lambda s=s: whole(s) for s in sets],
                                   [k for ks in K4_STEPS.values()
                                    for k in ks],
                                   "double" if es == 8 else "float"),
            n_sets=n_sets, live_ops=live, padded_ops=padded,
            ops_per_pair=live / K, padded_ops_per_pair=padded / K,
            **bound(nbytes, live + f_ops + o_ops, rate))
        out["padded_bound_ms"] = bound(nbytes, padded + f_ops + o_ops,
                                       rate)["bound_ms"]
        main_bytes = es * RS * N + 24 * K + es * 48 * K
        out["steps"] = {
            "unified_features": dict(
                ms=out["features_ms"], plain_ms=out["features_plain_ms"],
                **bound(es * (C + RS) * N + 4 * N, f_ops, rate)),
            "pair_order": dict(ms=out["order_ms"],
                               plain_ms=out["order_plain_ms"],
                               library_ms=out["order_library_ms"],
                               **bound(4 * N + 24 * K, o_ops)),
            "collide_support": dict(
                ms=out["main_ms"], plain_ms=out["plain_ms"],
                padded_bound_ms=bound(main_bytes, padded, rate)["bound_ms"],
                **bound(main_bytes, live, rate))}
        del sets
        msg += (f"; all launches {out['ms'] * 1e3:.2f} us L2-cold ({n_sets} "
                f"input sets: pre-pass {out['features_ms'] * 1e3:.2f}, pair "
                f"order {out['order_ms'] * 1e3:.2f}, per-pair kernel "
                f"{out['main_ms'] * 1e3:.2f}, in table order "
                f"{out['table_order_main_ms'] * 1e3:.2f}; stable torch.sort "
                f"of the class bins {out['order_library_ms'] * 1e3:.2f}; "
                f"per kernel {out['kernel_us']} us under the profiler), "
                f"{out['warm_ms'] * 1e3:.2f} us L2-warm; plain "
                f"{out['plain_ms'] * 1e3:.2f} us; bound "
                f"{out['bound_ms'] * 1e3:.2f} us live work ({out['bound_by']}:"
                f" {live / K:.0f} ops/pair), "
                f"{out['padded_bound_ms'] * 1e3:.2f} us padded "
                f"({padded / K:.0f} ops/pair); one call with its host work "
                f"{out['call_ms'] * 1e3:.1f} us")
    log(msg)
    return out


def random_pairs(n_bodies: int, K: int, seed: int, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    ka = torch.randint(0, n_bodies, (K,), generator=g, device=dev)
    kb = torch.randint(0, n_bodies, (K,), generator=g, device=dev)
    return ka, torch.where(kb == ka, (kb + 1) % n_bodies, kb)


def unified_pairs(st):
    """The live UNIFIED pairs of a state's manifold table, as the
    narrowphase selects them (both sides, in table order)."""
    from edyn_tpu_torch.collision import narrowphase as nph
    cls, _, _, _ = nph.live_classes(st, st.contacts)
    sel = (cls == nph.B_UNIFIED).nonzero()[:, 0]
    return st.contacts.body_a[sel].long(), st.contacts.body_b[sel].long()


def versus_support_sat(st, ka, kb, rim: bool,
                       label: str = "real step") -> dict:
    """K4 against the port's support_sat.collide_support (the jnp path's
    port) on the same pairs: the TPU kernel's own parity contract, on the
    card. support_sat runs in the narrowphase's CHUNK-pair chunks."""
    import torch
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    from edyn_tpu_torch.collision.kernels.support import (pack_side_table,
                                                          side_from_packed)
    from edyn_tpu_torch.collision.kernels.support_sat import collide_support
    from edyn_tpu_torch.collision.narrowphase import CHUNK
    tbl, dims = uk.pack_side_table_t(st)
    got = uk.collide_support_unified(tbl, ka, kb, dims, THRESHOLD, rim)
    packed, pdims = pack_side_table(st)
    pv, dist, nrm = [], [], []
    for c0 in range(0, len(ka), CHUNK):
        a, b = ka[c0:c0 + CHUNK], kb[c0:c0 + CHUNK]
        r = collide_support(side_from_packed(packed[a], pdims),
                            side_from_packed(packed[b], pdims), THRESHOLD,
                            rim_axes=rim)
        pv.append(r.point_valid)
        dist.append(r.distance)
        nrm.append(r.normal)
    out = parity_contract(got, torch.cat(pv), torch.cat(dist),
                          torch.cat(nrm), "K4 vs support_sat")
    log(f"[{label}] K4 against support_sat.collide_support: {out}")
    return out


def random_aabbs(n: int, seed: int, dev, side: float = 30.0):
    """n boxes in a cube of ``side`` m, half extents 0.1-0.8 m (in the 30 m
    cube about 14 overlaps a box at n = 65,573), 10% invalid."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    c = torch.rand((n, 3), generator=g, device=dev) * side
    h = 0.1 + 0.7 * torch.rand((n, 3), generator=g, device=dev)
    v = torch.rand((n,), generator=g, device=dev) > 0.1
    return (c - h).contiguous(), (c + h).contiguous(), v


def check_overlaps(amin, amax, valid, label: str, timed: bool) -> dict:
    """K5 against its plain version: the counts exactly equal. Timed when
    ``timed``: the kernel in CUDA-graph replays (L2-cold over rotating
    input sets, and L2-warm), the plain version (it synchronises per row
    block) and one call with its host work by CUDA events."""
    from edyn_tpu_torch.ops import overlap_count as ov
    got = ov.count_overlaps(amin, amax, valid)
    want = ov.count_overlaps_plain(amin, amax, valid)
    if got != want:
        raise AssertionError(f"[{label}] K5 counts {got}, plain {want}")
    N = amin.shape[0]
    out = dict(n=N, count=got, max_abs_err=float(abs(got - want)))
    msg = (f"[{label}] K5 {amin.dtype}: {N} boxes, {got} overlapping pairs, "
           "equal to plain")
    if timed:
        es = amin.element_size()
        nbytes = N * (3 * es + 3 * es + 1) + 8
        n_sets = max(2, -(-3 * L2_BYTES // nbytes))
        sets = [(amin.clone(), amax.clone(), valid.clone())
                for _ in range(n_sets - 1)] + [(amin, amax, valid)]
        kern = lambda a=amin, b=amax, v=valid: ov.count_overlaps_tensor(a, b,
                                                                         v)
        out.update(ms=device_ms([lambda s=s: ov.count_overlaps_tensor(*s)
                                 for s in sets]),
                   warm_ms=device_ms([kern]),
                   plain_ms=call_ms(lambda: ov.count_overlaps_plain(
                       amin, amax, valid), 3),
                   call_ms=call_ms(lambda: ov.count_overlaps(amin, amax,
                                                             valid), 20),
                   n_sets=n_sets,
                   **bound(nbytes, K5_OPS_PER_PAIR * N * (N - 1) / 2,
                           flops_per_s(amin.dtype)))
        del sets
        msg += (f"; device {out['ms'] * 1e3:.2f} us L2-cold ({n_sets} input "
                f"sets), {out['warm_ms'] * 1e3:.2f} us L2-warm; plain "
                f"{out['plain_ms'] * 1e3:.2f} us; bound "
                f"{out['bound_ms'] * 1e3:.2f} us ({out['bound_by']}); one "
                f"call with its host work {out['call_ms'] * 1e3:.1f} us")
    log(msg)
    return out


def k5_edge_cases(dev, dtype=None) -> dict:
    """K5 on the inputs its exactness must survive, each count equal to the
    plain one: N below one tile (300) and not a multiple of it (1,000),
    every box invalid, infinite extents, 1e30 extents, and a row of boxes
    whose faces touch exactly; the boxes at ``dtype`` (default float32)."""
    import torch
    dtype = dtype or torch.float32
    inf = float("inf")
    cases = {"300 boxes": random_aabbs(300, 11, dev, side=6.0),
             "1,000 boxes": random_aabbs(1000, 12, dev, side=9.0)}
    amin, amax, v = random_aabbs(2000, 13, dev, side=12.0)
    cases["all invalid"] = (amin, amax, torch.zeros_like(v))
    amin, amax, v = (x.clone() for x in random_aabbs(2000, 14, dev,
                                                     side=12.0))
    amin[::3, 1] = -inf
    amax[::5, 0] = inf
    amin[7::11] = -inf
    amax[7::11] = inf
    cases["infinite extents"] = (amin, amax, v)
    amin, amax, v = (x.clone() for x in random_aabbs(2000, 15, dev,
                                                     side=12.0))
    amin[::4, 2] = -1e30
    amax[1::4] = 1e30
    cases["1e30 extents"] = (amin, amax, v)
    lo = torch.arange(700, device=dev, dtype=torch.float32)[:, None] \
        * torch.tensor([1.0, 0.0, 0.0], device=dev)
    cases["touching faces"] = (lo, lo + 1.0,
                               torch.ones(700, dtype=torch.bool, device=dev))
    return {name: check_overlaps(a.to(dtype).contiguous(),
                                 b.to(dtype).contiguous(), v, name, False)
            for name, (a, b, v) in cases.items()}


def max_launches_per_step(s) -> dict:
    """Each counted kernel step's most launches in one unsharded step under
    Settings ``s``. K1, K3a, K2 and K3b run fused on the card: their
    unfused entries (the CPU's path) must not launch at all."""
    rest = s.num_restitution_iterations \
        * s.num_individual_restitution_iterations
    pos = s.num_solver_position_iterations
    return {"solve_iteration_fused": s.num_solver_velocity_iterations,
            "ngs_iteration_fused": pos,
            "restitution_iteration_fused": rest,
            "relvel_fused": s.num_restitution_iterations,
            "segment_sum": s.num_solver_velocity_iterations + rest + pos,
            "solve_iteration": 0, "restitution_iteration": 0,
            "ngs_iteration": 0, "relvel": 0,
            "unified_features": 1, "pair_order": 1, "collide_support": 1,
            "count_overlaps": 0, "merge": 1}


# the unfused K1, K3a, K2 and K3b: never on the card's step
UNFUSED = ("solve_iteration", "restitution_iteration", "ngs_iteration",
           "relvel")


def no_unfused(launches: dict, label: str):
    """Fail if the card's step launched K1, K3a, K2 or K3b unfused."""
    ran = {k: launches[k] for k in UNFUSED if launches.get(k)}
    if ran:
        raise AssertionError(f"[{label}] the unfused K1/K3a/K2/K3b launched "
                             f"on the step: {ran}")


def main_path(n_bodies: int, steps: int, dev):
    """Phase 3: the port's main path through the user-facing entry points."""
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.collision.kernels import merge_kernel as mk
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    from edyn_tpu_torch.utils.scenes import mixed_pile

    t0 = time.perf_counter()
    builder, _ = mixed_pile(n_bodies=n_bodies, seed=0)
    world = et.make_world(builder, et.Settings(), device=dev)
    torch.cuda.synchronize()
    log(f"[main] built {n_bodies} bodies in {time.perf_counter() - t0:.2f} s;"
        f" capacity {world.state.capacity}, max_pairs {world.meta.max_pairs},"
        f" max_rows {world.meta.max_rows}, has_spin_roll "
        f"{world.meta.has_spin_roll}")

    sk.reset_launch_counts()
    uk.reset_launch_counts()
    mk.reset_launch_counts()
    t0 = time.perf_counter()
    first = max(1, steps - 20)
    with MergeWatch("10k pile") as watch:
        world.step_n(first)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        world.step_n(steps - first)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(sk.LAUNCHES, **uk.LAUNCHES, **mk.LAUNCHES)

    st = world.state
    per_step = max_launches_per_step(world.settings)
    awake = int((st.awake_dynamic).sum())
    rows_count = rows_in_use(world)
    log(f"[main] {steps} steps in {t2 - t0:.3f} s = "
        f"{steps / (t2 - t0):.3f} steps/s; first {first}: "
        f"{first / (t1 - t0):.3f} steps/s, last {steps - first}: "
        f"{(steps - first) / (t2 - t1):.3f} steps/s")
    log(f"[main] rows.count {rows_count}, awake bodies {awake}, overflow "
        f"{world.overflow_counters()}, launches {launches}")

    for name, n in launches.items():
        most = per_step[name] * steps
        if not (0 < n <= most if most else n == 0):
            raise AssertionError(f"{name}: {n} launches in {steps} steps, "
                                 f"expected {f'1..{most}' if most else 0}")
    if launches["merge"] != steps:
        raise AssertionError(f"merge: {launches['merge']} launches in "
                             f"{steps} steps, one a step expected")
    lowest = check_pile(st, -FLOOR_BURIAL, "main")
    log(f"[main] max_pairs grew to {world.meta.max_pairs}")
    merge = watched_merges(watch, "10k pile, landed")
    return world, launches, dict(
        steps=steps, seconds=t2 - t0, steps_per_s=steps / (t2 - t0),
        last_steps_per_s=(steps - first) / (t2 - t1), rows_count=rows_count,
        awake=awake, overflow=world.overflow_counters(),
        max_pairs=world.meta.max_pairs, lowest_centre=lowest, merge=merge)


# How deep a body centre may sit below the floor at the end of the main
# path. Neither package has continuous collision detection or enough solver
# iterations to hold a tall pile rigid, so bodies landing in a pile sink in.
# On the CPU the JAX package buries centres up to 0.149 m into the floor of
# a 5,000-body mixed_pile within 120 steps (0.110, 0.108 and 0.149 m for
# seeds 0-2), and up to 0.056 m at 2,000 bodies (scripts/
# pile_floor_depth.py). The 10k pile falls from higher, so the 5,000-body
# reading bounds it from the strict side.
FLOOR_BURIAL = 0.149


def check_pile(st, floor: float, label: str) -> float:
    """The checks of the JAX package's test_mixed_pile_settles_and_no_
    tunnel: finite state, every body centre above ``floor``, the pile not
    collapsed into the floor, no body out of the bin. Returns the lowest
    centre."""
    import torch
    for f in ("pos", "orn", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(st, f)).all()):
            raise AssertionError(f"[{label}] state.{f} is not finite")
    dyn = st.is_dynamic
    y = st.origin_pos()[dyn][:, 1]
    lowest = float(y.min())
    log(f"[{label}] lowest body centre y = {lowest:.5f} (bound {floor}), "
        f"centres below 0: {int((y < 0).sum())} of {int(dyn.sum())}, lowest "
        f"body top y = {float(st.aabb_max[dyn][:, 1].min()):.5f}, median "
        f"centre y = {float(y.median()):.5f}")
    if not lowest > floor:
        raise AssertionError(f"[{label}] a body centre is at y = {lowest}, "
                             f"below {floor}")
    if float(y.median()) < 0.08:
        raise AssertionError(f"[{label}] the pile collapsed into the floor")
    if float(st.pos[dyn][:, [0, 2]].abs().max()) > 25.0:
        raise AssertionError(f"[{label}] a body escaped the bin")
    return lowest


def suggest_path(world) -> dict:
    """The ``suggest_max_pairs`` entry point once on the landed pile: K5
    launched once, its budget that of the plain count."""
    from edyn_tpu_torch.ops import overlap_count as ov
    st = world.state
    ov.reset_launch_counts()
    budget = ov.suggest_max_pairs(st)
    launches = ov.LAUNCHES["count_overlaps"]
    plain = ov.count_overlaps_plain(st.aabb_min, st.aabb_max, st.valid)
    log(f"[suggest] suggest_max_pairs = {budget} (plain count {plain}, "
        f"max_pairs {world.meta.max_pairs}); K5 launches {launches}")
    if launches != 1:
        raise AssertionError(f"suggest_max_pairs launched K5 {launches} "
                             "times, 1 expected")
    if budget != max(256, int(plain * 1.5)):
        raise AssertionError(f"suggest_max_pairs gives {budget}, the plain "
                             f"count {plain} gives {max(256, int(plain * 1.5))}")
    return dict(budget=budget, count=plain, launches=launches)


def reference_pile(dev) -> float:
    """The JAX package's test_mixed_pile_settles_and_no_tunnel on the card:
    ``mixed_pile(60)`` settled for 240 steps keeps every centre above the
    floor."""
    import edyn_tpu_torch as et
    from edyn_tpu_torch.utils.scenes import mixed_pile
    b, _ = mixed_pile(n_bodies=60)
    w = et.make_world(b, device=dev)
    w.step(240)
    return check_pile(w.state, 0.0, "pile of 60")


def rows_in_use(world) -> int:
    from edyn_tpu_torch.simulation.stepper import prepare_rows
    _, _, rows, _ = prepare_rows(world.state, world.settings, world.meta)
    return int(rows.count)


def real_inputs(world):
    """Kernel inputs from one real step of the world: the packed table at
    the width the step solves, the warm-start impulses, and the gathered
    body velocities; for the fused iterations the endpoints, the body
    velocities and the bodies that can move."""
    import torch
    from edyn_tpu_torch.dynamics import scatter
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    from edyn_tpu_torch.dynamics.solver import rows_prefix
    from edyn_tpu_torch.simulation.stepper import prepare_rows, solve_width
    st, man, rows, _ = prepare_rows(world.state, world.settings, world.meta)
    width = solve_width(rows, world.meta)
    if width < rows.valid.shape[0]:
        rows = rows_prefix(rows, width)
    tbl, a_p, b_p, Rp = sk.pack_rows_t(rows)
    ab_p = torch.cat([a_p, b_p])
    M, P = man.point_valid.shape
    imp = torch.cat([man.normal_impulse[..., None], man.friction_impulse,
                     man.spin_impulse[..., None], man.roll_impulse], -1)
    imp6 = imp.reshape(M * P, 6)[rows.row_slot]
    imp6 = torch.nn.functional.pad(imp6, (0, 0, 0, Rp - imp6.shape[0]))
    vel_t = torch.cat([st.linvel, st.angvel], 1).T.contiguous()
    g = vel_t[:, ab_p].contiguous()
    relv = sk.relvel_plain(tbl, g)
    restit = tbl[56:57]
    dyn = torch.cat([-relv * (1.0 + restit),
                     ((tbl[55:56] > 0.5) & (relv < -0.005)).to(tbl.dtype)])
    return dict(tbl=tbl, imp=imp6.T.contiguous(),
                imp3=imp6[:, :3].T.contiguous(), g=g,
                dyn=dyn.contiguous(), ab=ab_p, vel=vel_t.T.contiguous(),
                moves=scatter.movable(st)), rows.sA_n is not None


def _to(x, dev):
    """A state, table or row structure with every tensor moved to dev."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):  # the user components
        return {k: _to(v, dev) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _to(getattr(x, f.name), dev)
                                         for f in dataclasses.fields(x)})
    return x


def _hold(label, pairs):
    """Each (name, card, cpu, rtol, atol) must agree elementwise."""
    import numpy as np
    worst = {}
    for f, a, b, rtol, atol in pairs:
        a, b = a.cpu().numpy(), b.cpu().numpy()
        excess = np.abs(a - b) - (atol + rtol * np.abs(b))
        worst[f] = float(np.abs(a - b).max())
        if (excess > 0).any():
            i = np.unravel_index(np.argmax(excess), excess.shape)
            raise AssertionError(f"{label}: card and CPU differ in {f} at "
                                 f"{i}: {a[i]} vs {b[i]}")
    return worst


# whole-step parity tolerances of tests/test_torch_step.py
STEP_TOL = (("pos", 1e-3, 2e-3), ("orn", 1e-3, 2e-3), ("linvel", 1e-3, 5e-3))


def _nudged(tree, seed=None, mask=None, ulps: int = 1, up: bool = True,
            field: str = "pos"):
    """A copy of a numpy state tree with body positions (or orientations,
    ``field="orn"``) moved by ``ulps`` ulps of their dtype: those under
    ``mask`` all one way (``up`` or down), or, with a ``seed``, every
    body's each component a random way."""
    import numpy as np
    val = tree[field]
    if seed is not None:
        rise = np.random.default_rng(seed).random(val.shape) < 0.5
        mask = np.ones(len(val), bool)
    else:
        rise = np.full(val.shape, up)
    new = val.copy()
    for _ in range(ulps):
        new = np.where(rise, np.nextafter(new, val.dtype.type(np.inf)),
                       np.nextafter(new, val.dtype.type(-np.inf)))
    return dict(tree, **{field: np.where(mask[:, None], new, val).astype(
        val.dtype)})


# A manifold whose point validity differs, or a point of which moved more
# than this (m), has another point set: another feature won (P2)
POINT_MOVED = 1e-4


def card_vs_cpu(dev, n_bodies: int = 1000, settle: int = 240,
                builder=None, label: str = "card-vs-cpu", settings=None,
                nudge_orn: bool = False):
    """Phase 5 (and phase 6 on ``builder``, a ragdoll pile): one whole step
    of a settled pile in contact, on the card and from a copy of its state
    on the CPU (the kernels' plain versions), held per body at the
    whole-step tolerances with the rule of tests/test_torch_step.py's
    ``check_step``.

    The card's float sums, matrix products, sqrt and sin round differently
    from the CPU's (scripts/torch_device_diff.py), and contact generation
    turns some 1-ulp differences into another contact point set, or a
    contact kept or dropped (ROADMAP.md queue 3, P1 and P2). So a body
    outside the tolerances passes only where the CPU step itself is that
    sensitive: its difference must be at most twice the largest change that
    a 1-ulp perturbation of the start state makes to the CPU step there.
    The perturbations: the positions of the bodies outside the tolerances
    moved 1 and 2 ulps up and down (``check_step``'s), and every position
    moved 1 ulp a random way, four times; with ``nudge_orn``, the same
    perturbations of the orientations too. The pile is settled for 240 steps
    (the JAX package's test_mixed_pile_settles_and_no_tunnel) because while
    it still lands, a 1-ulp perturbation moves half its bodies past the
    tolerances.

    Also held exactly: the pair lists and island labels. And the solve
    phase alone, run on both devices from the CPU's contact rows, at the
    whole-step tolerances. Returns (summary, the settled world)."""
    import numpy as np
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.core.convert import state_from_numpy, state_to_numpy
    from edyn_tpu_torch.dynamics.solver import rows_prefix
    from edyn_tpu_torch.parallel import make_mesh
    from edyn_tpu_torch.simulation import stepper
    from edyn_tpu_torch.utils.scenes import mixed_pile

    if builder is None:
        builder, _ = mixed_pile(n_bodies=n_bodies, seed=1)
    w = et.make_world(builder, settings or et.Settings(), device=dev)
    w.step_n(settle)
    tree = state_to_numpy(w.state)
    s, meta = w.settings, w.meta
    card = stepper.prepare_rows(state_from_numpy(tree, dev), s, meta)
    cpu = stepper.prepare_rows(state_from_numpy(tree, "cpu"), s, meta)

    # pairs and islands
    mc, mp = _to(card[1], "cpu"), cpu[1]
    for f in ("key", "body_a", "body_b", "valid", "sort_key", "sort_slot"):
        if not torch.equal(getattr(mc, f), getattr(mp, f)):
            raise AssertionError(f"card and CPU pair lists differ in {f}")
    if not torch.equal(card[0].island_id.cpu(), cpu[0].island_id):
        raise AssertionError("card and CPU island labels differ")
    live = mp.valid & (mp.point_valid.any(1) | mc.point_valid.any(1))
    n_live = int(live.sum())
    other_pts = int((live & ~((mc.point_valid == mp.point_valid).all(1) & (
        (mc.pivot_a - mp.pivot_a).abs().amax((1, 2)) < POINT_MOVED))).sum())

    # the solve phase from the CPU's rows on both devices
    st, man, rows, _ = cpu
    width = stepper.solve_width(rows, meta)
    if width < rows.valid.shape[0]:
        rows = rows_prefix(rows, width)
    use_rest = s.num_restitution_iterations > 0
    def solve_phase(st, man, rows, mesh):
        parts = [rows]
        return stepper._solve_phase(st, man, parts,
                                    stepper._pack(parts, mesh), s, meta,
                                    use_rest, mesh)

    got = solve_phase(_to(st, dev), _to(man, dev), _to(rows, dev),
                      make_mesh([dev]))
    want = solve_phase(st, man, rows, make_mesh(["cpu"]))
    solve = _hold("solve phase", [(f, getattr(got, f), getattr(want, f), r, a)
                                  for f, r, a in STEP_TOL])

    # the whole step, per body
    def cpu_step(t):
        out = stepper.physics_step(state_from_numpy(t, "cpu"), s, meta)
        return {f: getattr(out, f).numpy() for f, _, _ in STEP_TOL}

    a = stepper.physics_step(state_from_numpy(tree, dev), s, meta)
    a = {f: getattr(a, f).cpu().numpy() for f, _, _ in STEP_TOL}
    b = cpu_step(tree)
    diff = {f: np.abs(a[f] - b[f]) for f in a}
    bad = np.zeros(len(tree["pos"]), bool)
    for f, rtol, atol in STEP_TOL:
        if not np.isfinite(a[f]).all():
            raise AssertionError(f"the card's step gives a {f} not finite")
        bad |= (diff[f] > atol + rtol * np.abs(b[f])).any(-1)
    sens = {f: np.zeros_like(d) for f, d in diff.items()}
    if bad.any():
        fields = ("pos", "orn") if nudge_orn else ("pos",)
        alts = [_nudged(tree, mask=bad, ulps=k, up=up, field=f)
                for f in fields for k in (1, 2) for up in (True, False)]
        alts += [_nudged(tree, seed=k, field=f) for f in fields
                 for k in range(4)]
        for t in alts:
            c = cpu_step(t)
            for f in sens:
                sens[f] = np.maximum(sens[f], np.abs(c[f] - b[f]))
    for f, rtol, atol in STEP_TOL:
        tol = atol + rtol * np.abs(b[f])
        over = bad[:, None] & (diff[f] > np.maximum(tol, 2 * sens[f]))
        for i in np.nonzero(over.any(-1))[0]:
            log(f"[{label}] body {i}: {f} differs by {diff[f][i].max()} "
                f"(tolerance {tol[i].max()}, 1-ulp sensitivity "
                f"{sens[f][i].max()})")
        if over.any():
            i = np.nonzero(over.any(-1))[0]
            raise AssertionError(
                f"card and CPU steps differ in {f} of bodies {i} by up "
                f"to {diff[f][i].max()}, beyond twice the CPU step's own "
                f"1-ulp sensitivity {sens[f][i].max()} there")
    n_dyn = int(st.is_dynamic.sum())
    full = {f: float(d.max()) for f, d in diff.items()}
    largest = {f: float(v[bad].max()) if bad.any() else 0.0
               for f, v in sens.items()}
    log(f"[{label}] {n_dyn} dynamic bodies after {settle} steps: pair lists "
        f"and islands equal; {n_live} live manifolds, {other_pts} with "
        f"another point set; solve phase from the same rows max abs diff "
        f"{solve}; whole step max abs diff {full}, {int(bad.sum())} of "
        f"{n_dyn} bodies outside the tolerances, none beyond twice the CPU "
        f"step's 1-ulp sensitivity (largest sensitivity there {largest})")
    return dict(settle=settle, live_manifolds=n_live,
                point_sets_differ=other_pts, solve=solve, full_step=full,
                bodies_outside_tol=int(bad.sum()),
                dynamic_bodies=n_dyn), w



# The cone row of both packages asks for ~1e7 rad/s once a limb swings near
# 90 degrees out of its cone, and the JAX package's ragdoll pile then blows
# up on the CPU (at step 44 with 384 ragdolls, at step 59 with 48; ROADMAP
# R8). The ragdoll piles of phase 6 therefore run with the port's opt-in
# cap on the cone row's violation (ey^2 + ez^2 - 1). Its value is a choice,
# not the C++ reference's (the repo does not hold cone_constraint.cpp): at
# 2 the swing's tangent is sqrt(3) times the cone's. So these piles are not
# reference results; the one-ragdoll test runs with the default settings,
# the JAX package's row.
RAGDOLL_CONE_CAP = 2.0
# How deep a ragdoll body centre may sit below the floor at any of the 120
# steps of the joint path. The reference is the same pile (768 ragdolls,
# the cap above) stepped by the port on the CPU, the plain versions of
# every kernel (the JAX package cannot step it: R8), read the same way: the
# deepest centre of any step, at seeds 0-3 (scripts/pile_floor_depth.py
# --package torch --device cpu --ragdolls 768 --seed S, 8-core host of an
# NVIDIA H100 80GB HBM3 machine). Those readings, all at steps 61-63:
RAGDOLL_FLOOR_READINGS = (-0.05743, -0.06870, -0.10075, -0.09197)
# (+0.01645, +0.01575, +0.01517, +0.00434 m at step 120). A landing pile is
# chaotic, and the card's float rounding differs from the CPU's, so one
# run of the card is one more draw: the bound is the deepest reading less
# the spread of the four (-0.14407 m). The card read -0.09421, -0.07296,
# -0.07446 and -0.06741 at the same seeds, and -0.080 and -0.084 in two
# more runs of seed 0.
RAGDOLL_FLOOR = min(RAGDOLL_FLOOR_READINGS) - (
    max(RAGDOLL_FLOOR_READINGS) - min(RAGDOLL_FLOOR_READINGS))
# The JAX package's own ragdoll limits (tests/test_ragdoll.py)
RAGDOLL_LINK = 0.5   # head-to-upper-torso and knee centre distances, m
BIN_HALF = 9.0       # ragdoll_pile's walls


def pivot_gaps(st):
    """|pivot A - pivot B| in the world of every valid point and hinge
    joint (the pivots are in the origin frame, arms about the COM)."""
    import torch
    from edyn_tpu_torch.constraints.joints import JointType
    from edyn_tpu_torch.math import quat
    jt = st.joints
    sel = jt.valid & ((jt.jtype == int(JointType.POINT))
                      | (jt.jtype == int(JointType.HINGE)))
    a, b = jt.body_a[sel].long(), jt.body_b[sel].long()
    pa = st.pos[a] + quat.rotate(st.orn[a], jt.pivot_a[sel] - st.com[a])
    pb = st.pos[b] + quat.rotate(st.orn[b], jt.pivot_b[sel] - st.com[b])
    return torch.linalg.vector_norm(pa - pb, dim=-1)


def check_ragdolls(st, rags, start_y, deepest: float, floor: float,
                   label: str) -> dict:
    """The joint path's checks at its last step: finite state; every
    ragdoll's head-to-upper-torso and both upper-to-lower-leg centre
    distances under RAGDOLL_LINK; no centre more than 1 m outside the bin
    or above its start height; ``deepest``, the deepest centre of any step,
    above ``floor``."""
    import torch
    for f in ("pos", "orn", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(st, f)).all()):
            raise AssertionError(f"[{label}] state.{f} is not finite")
    pos = st.pos.cpu()
    idx = lambda name: torch.tensor([getattr(r, name) for r in rags])
    links = {}
    for a, b in (("head", "torso_upper"),
                 ("upper_leg_left", "lower_leg_left"),
                 ("upper_leg_right", "lower_leg_right")):
        d = torch.linalg.vector_norm(pos[idx(a)] - pos[idx(b)], dim=-1)
        links[f"{a}-{b}"] = float(d.max())
        if float(d.max()) >= RAGDOLL_LINK:
            raise AssertionError(
                f"[{label}] {a} and {b} of ragdoll {int(d.argmax())} are "
                f"{float(d.max()):.3f} m apart (limit {RAGDOLL_LINK})")
    body = torch.tensor([i for r in rags for i in r.bodies()])
    y = pos[body, 1]
    out_of_bin = float(pos[body][:, [0, 2]].abs().max()) - BIN_HALF
    rise = float((y - start_y[body]).max())
    lowest = float(y.min())
    gaps = pivot_gaps(st)
    log(f"[{label}] {len(rags)} ragdolls: largest link distances {links}; "
        f"deepest centre y {deepest:.5f} over all steps (bound {floor}), "
        f"{lowest:.5f} at the last; farthest centre "
        f"{out_of_bin:+.3f} m beyond the walls; largest rise above the "
        f"start {rise:+.3f} m; pivot gap over {gaps.numel()} point and "
        f"hinge joints: largest {float(gaps.max()):.5f} m, median "
        f"{float(gaps.median()):.6f} m")
    if out_of_bin > 1.0:
        raise AssertionError(f"[{label}] a ragdoll left the bin")
    if rise > 0.0:
        raise AssertionError(f"[{label}] a body rose above its start")
    if not deepest > floor:
        raise AssertionError(f"[{label}] a body centre reached y = "
                             f"{deepest}, below {floor}")
    return dict(links=links, deepest_centre=deepest,
                lowest_centre_last=lowest, beyond_walls=out_of_bin,
                rise=rise, pivot_gap_max=float(gaps.max()),
                pivot_gap_median=float(gaps.median()))


def ragdoll_settings():
    """The settings of phase 6's ragdoll piles: the defaults with the cone
    row's violation capped at RAGDOLL_CONE_CAP."""
    import edyn_tpu_torch as et
    return et.Settings(cone_max_violation=RAGDOLL_CONE_CAP)


def ragdoll_path(n_ragdolls: int, steps: int, dev):
    """Phase 6: the ragdoll pile through the user-facing entry points, with
    every kernel's launch count set to 0 just before the steps and read
    just after. K1, K2 and K4 must run and K5 must not; the ragdolls'
    restitution is 0, so the restitution pre-pass stops after its first
    K3b launch each step. The deepest body centre of every step is kept on
    the card (no host read). Returns (summary, launches, world)."""
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    from edyn_tpu_torch.constraints import joints as tj
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    from edyn_tpu_torch.ops import overlap_count as ov

    t0 = time.perf_counter()
    builder, rags = ragdoll_pile(et, n_ragdolls)
    world = et.make_world(builder, ragdoll_settings(), device=dev)
    st = world.state
    torch.cuda.synchronize()
    n_joints = int(st.joints.valid.sum())
    log(f"[ragdolls] built {n_ragdolls} ragdolls, {st.capacity} bodies, "
        f"{n_joints} joints, {int((st.exclusions >= 0).sum()) // 2} "
        f"exclusions in {time.perf_counter() - t0:.2f} s; max_pairs "
        f"{world.meta.max_pairs}, has_joints {world.meta.has_joints}, "
        f"joint types {sorted(t.name for t in world.meta.joint_types)}, "
        f"cone cap {world.settings.cone_max_violation}")
    if not world.meta.has_joints or st.device.type != torch.device(dev).type:
        raise AssertionError(f"the ragdoll world is not a jointed world on "
                             f"{dev}")
    start_y = st.pos[:, 1].cpu()
    body = torch.tensor([i for r in rags for i in r.bodies()],
                        device=st.device)
    deepest = torch.full((), float("inf"), device=st.device)

    sk.reset_launch_counts()
    uk.reset_launch_counts()
    ov.reset_launch_counts()
    t0 = time.perf_counter()
    first = max(1, steps - 20)
    for i in range(steps):
        if i == first:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        world.step()
        deepest = torch.minimum(deepest, world.state.pos[body, 1].min())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(sk.LAUNCHES, **uk.LAUNCHES, **ov.LAUNCHES)

    s = world.settings
    per_step = max_launches_per_step(s)
    for name, n in launches.items():
        if n > per_step[name] * steps:
            raise AssertionError(f"[ragdolls] {name}: {n} launches in "
                                 f"{steps} steps, at most "
                                 f"{per_step[name] * steps}")
    for name in ("solve_iteration_fused", "segment_sum",
                 "ngs_iteration_fused", "relvel_fused", "unified_features",
                 "pair_order", "collide_support"):
        # (the plain versions on a CPU rehearsal count nothing)
        if launches[name] == 0 and torch.device(dev).type == "cuda":
            raise AssertionError(f"[ragdolls] {name} never launched")
    st = world.state
    jrows, _ = tj.build_joint_rows(st, s.fixed_dt, s.mass_splitting,
                                   types=world.meta.joint_types,
                                   cone_cap=s.cone_max_violation)
    live_rows = int(jrows.valid.sum())
    log(f"[ragdolls] {steps} steps in {t2 - t0:.3f} s = "
        f"{steps / (t2 - t0):.3f} steps/s, "
        f"{1e3 * (t2 - t0) / steps:.2f} ms/step; first {first}: "
        f"{first / (t1 - t0):.3f} steps/s, last {steps - first}: "
        f"{(steps - first) / (t2 - t1):.3f} steps/s "
        f"({1e3 * (t2 - t1) / (steps - first):.2f} ms/step)")
    log(f"[ragdolls] joint rows: {live_rows} live of "
        f"{jrows.valid.numel()} evaluated; contact rows "
        f"{rows_in_use(world)}; awake bodies {int(st.awake_dynamic.sum())};"
        f" overflow {world.overflow_counters()}; launches {launches}, per "
        f"step { {k: v / steps for k, v in launches.items()} }")
    checks = check_ragdolls(st, rags, start_y, float(deepest),
                            RAGDOLL_FLOOR, "ragdolls")
    return dict(n_ragdolls=n_ragdolls, bodies=st.capacity, joints=n_joints,
                steps=steps, seconds=t2 - t0, steps_per_s=steps / (t2 - t0),
                ms_per_step=1e3 * (t2 - t0) / steps,
                last_ms_per_step=1e3 * (t2 - t1) / (steps - first),
                live_joint_rows=live_rows,
                joint_rows=jrows.valid.numel(), launches=launches,
                max_pairs=world.meta.max_pairs, **checks), launches, world


# the JAX package's ragdoll test: 240 steps; the second run, which must
# retrace the first bit for bit, is held to it after its first 60
ONE_RAGDOLL_STEPS = 240
ONE_RAGDOLL_AGAIN = 60


def reference_ragdoll(dev) -> dict:
    """The JAX package's test_ragdoll_drops_and_holds_together on the card:
    one ragdoll dropped on a plane, 240 steps, its own limits, the default
    settings (the cone row unbounded, ROADMAP R8). A second run must
    retrace the first, bit for bit, over its first ``ONE_RAGDOLL_AGAIN``
    steps: the card's step sums each body's row updates in one fixed order
    (``solver.index_sum``, and ``segment_sum`` in the same order). With
    ``index_add``'s atomics the order changed from run to run, and one run
    in about five blew this ragdoll up (R8)."""
    import numpy as np
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.utils.ragdoll import RagdollDef, make_ragdoll
    fields = ("pos", "orn", "linvel", "angvel")

    def world():
        b = et.WorldBuilder()
        b.make_rigidbody(et.RigidBodyDef(
            kind=et.KIND_STATIC, shape=et.PlaneShape((0, 1, 0), 0.0),
            material=et.Material(friction=0.8)))
        rag = make_ragdoll(b, RagdollDef(position=(0, 0.3, 0)))
        return et.make_world(b, device=dev), rag

    w, rag = world()
    t0 = time.perf_counter()
    w.step(ONE_RAGDOLL_AGAIN)
    early = {f: getattr(w.state, f).clone() for f in fields}
    w.step(ONE_RAGDOLL_STEPS - ONE_RAGDOLL_AGAIN)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    again, _ = world()
    again.step(ONE_RAGDOLL_AGAIN)
    for f in fields:
        if not torch.equal(early[f], getattr(again.state, f)):
            raise AssertionError(f"[one ragdoll] two runs of the same scene "
                                 f"differ in {f} after {ONE_RAGDOLL_AGAIN} "
                                 "steps on the card")
    pos = np.array([w.position(i) for i in rag.bodies()])
    d_head = float(np.linalg.norm(w.position(rag.head)
                                  - w.position(rag.torso_upper)))
    d_knee = float(np.linalg.norm(w.position(rag.upper_leg_left)
                                  - w.position(rag.lower_leg_left)))
    out = dict(lowest=float(pos[:, 1].min()), extent=float(np.abs(pos).max()),
               head=d_head, knee=d_knee, seconds=secs)
    log(f"[one ragdoll] {ONE_RAGDOLL_STEPS} steps on the card in "
        f"{secs:.2f} s; a second run the same state bit for bit after "
        f"{ONE_RAGDOLL_AGAIN}: {out}")
    if not (out["lowest"] > -0.05 and out["extent"] < 5.0
            and d_head < 0.5 and d_knee < 0.5):
        raise AssertionError(f"the JAX package's ragdoll test fails on the "
                             f"card: {out}")
    return out


# card against CPU on the joint functions alone: each output element within
# JOINT_RTOL of itself plus JOINT_RTOL of the output's largest magnitude
# (entries at +-BIG, the joint rows' open bounds, equal). The second term is
# the rounding of the summands: a row's `tA` = I^-1 J of a light limb sums
# terms near 100 into a result near 0.04, and CUDA's matrix products and
# index_add round them differently from the CPU's (1.5e-5 apart there).
JOINT_RTOL = 1e-5


def _hold_scaled(label, pairs):
    """Each (name, card, cpu) within JOINT_RTOL as above. Returns each
    output's largest difference over its largest magnitude."""
    import torch
    worst = {}
    for f, a, b in pairs:
        a, b = a.cpu().double(), b.cpu().double()
        big = b.abs() >= 1e17
        if not torch.equal(a[big], b[big]):
            raise AssertionError(f"{label}: card and CPU differ in {f} at "
                                 f"an open bound")
        scale = float(b[~big].abs().max()) if (~big).any() else 0.0
        diff = (a - b).abs().masked_fill(big, 0.0)
        excess = diff - JOINT_RTOL * (b.abs() + scale)
        worst[f] = float(diff.max()) / scale if scale > 0 else float(
            diff.max())
        if bool((excess > 0).any()):
            k = int(excess.flatten().argmax())
            raise AssertionError(
                f"{label}: card and CPU differ in {f} at flat index {k}: "
                f"{float(a.flatten()[k])} vs {float(b.flatten()[k])} "
                f"(largest |{f}| {scale})")
    return worst


def joints_card_vs_cpu(dev, n_ragdolls: int = 16, settle: int = 240) -> dict:
    """Phase 6, card against CPU: one whole step of a 16-ragdoll pile
    settled 240 steps on the card, held per body against the CPU's under
    the 1-ulp rule (``card_vs_cpu``); then ``build_joint_rows``,
    ``solve_joints_once`` and ``solve_joint_positions`` alone on its
    state, on both devices from the same inputs, every output within
    JOINT_RTOL (``_hold_scaled``)."""
    import dataclasses
    import numpy as np
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.constraints import joints as tj

    builder, _ = ragdoll_pile(et, n_ragdolls, seed=1)
    step, w = card_vs_cpu(dev, settle=settle, builder=builder,
                          label="joints card-vs-cpu",
                          settings=ragdoll_settings())
    st_card = w.state
    st_cpu = _to(st_card, "cpu")
    dt, cap = w.settings.fixed_dt, w.settings.cone_max_violation
    rc, ac = tj.build_joint_rows(st_card, dt, cone_cap=cap)
    rp, ap = tj.build_joint_rows(st_cpu, dt, cone_cap=cap)
    pairs = [(f.name, getattr(rc, f.name), getattr(rp, f.name))
             for f in dataclasses.fields(rc)]
    rows = _hold_scaled("build_joint_rows", pairs + [("new_angle", ac, ap)])
    rng = np.random.default_rng(0)
    N = st_cpu.capacity
    dvw = torch.as_tensor(rng.normal(0, 0.1, (N, 6)).astype(np.float32))
    imp = st_cpu.joints.impulses
    ic, dc = tj.solve_joints_once(_to(rp, dev), imp.to(dev), dvw.to(dev))
    ip, dp = tj.solve_joints_once(rp, imp, dvw)
    once = _hold_scaled("solve_joints_once", [("impulses", ic, ip),
                                              ("dvw", dc, dp)])
    n_pos = w.settings.num_solver_position_iterations
    pc = tj.solve_joint_positions(st_card, n_pos)
    pp = tj.solve_joint_positions(st_cpu, n_pos)
    posn = _hold_scaled("solve_joint_positions",
                        [(f, getattr(pc, f), getattr(pp, f))
                         for f in ("pos", "orn")])
    live = int(rp.valid.sum())
    log(f"[joints card-vs-cpu] {live} live joint rows; largest difference "
        f"over the output's largest magnitude (tol {JOINT_RTOL} x (|cpu| + "
        f"largest |cpu|)): build_joint_rows {rows}; solve_joints_once "
        f"{once}; solve_joint_positions {posn}")
    return dict(step=step, live_rows=live, build_joint_rows=rows,
                solve_joints_once=once, solve_joint_positions=posn)


# The terrain path: the JAX package's rich_scene at the bench's body count
# (10,000 bodies over a 24 x 24 trimesh terrain, four wall planes, four
# hinge chains of six links).
N_TERRAIN = 10_000
# How deep a body centre may sit below the terrain surface at its (x, z), at
# any of the 120 steps of the terrain path. The reference is the JAX package
# on the CPU of an NVIDIA H100 80GB HBM3 machine's host: rich_scene(10_000)
# stepped with its jitted step, read the same way, the lowest centre of any
# step at seeds 0-3 (scripts/pile_floor_depth.py --package jax --scene
# terrain --bodies 10000 --seed S, four processes at once, 1,283-1,291 s
# each). Those readings, all at step 120:
TERRAIN_FLOOR_READINGS = (-6.51434, -10.42392, -9.23514, -9.51715)
# The terrain does not hold the whole pile in either package: 690-724
# bodies (7%) are below its surface at step 120, falling (ROADMAP R11); the
# port on the card read -9.29410, -6.03525, -7.86284 and -13.61134 at the
# same seeds. So the bound says how far the lost bodies may have fallen in
# 120 steps: the deepest reading less the spread of the four (-14.33350
# m), as for RAGDOLL_FLOOR, because a landing pile is chaotic and one card
# run is one more draw.
TERRAIN_FLOOR = min(TERRAIN_FLOOR_READINGS) - (
    max(TERRAIN_FLOOR_READINGS) - min(TERRAIN_FLOOR_READINGS))
# tests/test_joints.py: a point joint's pivots stay within 0.05 m
PIVOT_GAP = 0.05

# Phase 8 holds a settled rich_scene(512) step card against CPU under phase
# 5's rule, each body against its own 1-ulp sensitivity with positions and
# orientations nudged (ROADMAP P7): in the card's fixed order one of its 536
# bodies is outside the whole-step tolerances (an orn component 1.04 times
# the tolerance), within twice what a 1-ulp nudge of the orientations moves
# it on the CPU (NVIDIA H100 80GB HBM3, 700.00 W).


def terrain_clearance(mesh, dev):
    """fn(pos [K,3]) -> the height of each point above the surface of the
    MeshShape ``mesh`` (at rest, identity pose) at its (x, z), in float64;
    +inf off the mesh. Each point is located in the triangle whose (x, z)
    projection holds it, by barycentric coordinates."""
    import numpy as np
    import torch
    v = torch.as_tensor(np.asarray(mesh.vertices, np.float64), device=dev)
    t = torch.as_tensor(np.asarray(mesh.indices, np.int64), device=dev)
    p0, p1, p2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    det = ((p1[:, 2] - p2[:, 2]) * (p0[:, 0] - p2[:, 0])
           + (p2[:, 0] - p1[:, 0]) * (p0[:, 2] - p2[:, 2]))

    def clearance(pos):
        x = pos[:, 0:1].double() - p2[:, 0]
        z = pos[:, 2:3].double() - p2[:, 2]
        l0 = ((p1[:, 2] - p2[:, 2]) * x + (p2[:, 0] - p1[:, 0]) * z) / det
        l1 = ((p2[:, 2] - p0[:, 2]) * x + (p0[:, 0] - p2[:, 0]) * z) / det
        l2 = 1.0 - l0 - l1
        inside = (l0 >= -1e-9) & (l1 >= -1e-9) & (l2 >= -1e-9)
        h = l0 * p0[:, 1] + l1 * p1[:, 1] + l2 * p2[:, 1]
        h = torch.where(inside, h, torch.full_like(h, -float("inf")))
        return pos[:, 1].double() - h.amax(1)
    return clearance


def mesh_bucket_pairs(st):
    """The live MESH-bucket pairs of a state's manifold table, convex body
    first, as the narrowphase selects them."""
    import torch
    from edyn_tpu_torch.collision import narrowphase as nph
    cls, swap, _, _ = nph.live_classes(st, st.contacts)
    sel = (cls == nph.B_MESH).nonzero()[:, 0]
    a, b = st.contacts.body_a[sel].long(), st.contacts.body_b[sel].long()
    sw = swap[sel]
    return torch.where(sw, b, a), torch.where(sw, a, b)


def terrain_path(n_bodies: int, steps: int, dev):
    """Phase 7: the port's rich_scene through the user-facing entry points,
    with every kernel's launch count set to 0 just before the steps and read
    just after (K1, K2, K3b and K4 must run, K5 must not). The deepest body
    centre below the terrain surface of every step is kept on the card (no
    host read). Returns (summary, launches, world)."""
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    from edyn_tpu_torch.ops import overlap_count as ov
    from edyn_tpu_torch.shapes.mesh import candidate_tris
    from edyn_tpu_torch.math import quat
    from edyn_tpu_torch.utils.scenes import rich_scene

    t0 = time.perf_counter()
    builder, ids = rich_scene(n_bodies=n_bodies)
    mesh = builder.defs[0].shape
    world = et.make_world(builder, et.Settings(), device=dev)
    st = world.state
    torch.cuda.synchronize()
    extent = float(st.shape_params[1, 3].abs())    # the first wall's
    log(f"[terrain] built rich_scene({n_bodies}): {st.capacity} bodies, "
        f"{len(mesh.indices)} triangles (grid "
        f"{tuple(st.mesh.grid.shape[1:])}), walls at +-{extent:.3f} m, "
        f"{int(st.joints.valid.sum())} hinge joints in "
        f"{time.perf_counter() - t0:.2f} s; max_pairs "
        f"{world.meta.max_pairs}, bucket_cap {world.meta.bucket_cap}, "
        f"types {sorted(world.meta.types_present)}")
    clearance = terrain_clearance(mesh, st.device)
    body = torch.as_tensor(ids, device=st.device)
    deepest = torch.full((), float("inf"), device=st.device,
                         dtype=torch.float64)

    sk.reset_launch_counts()
    uk.reset_launch_counts()
    ov.reset_launch_counts()
    t0 = time.perf_counter()
    first = max(1, steps - 20)
    for i in range(steps):
        if i == first:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        world.step()
        deepest = torch.minimum(deepest,
                                clearance(world.state.pos[body]).min())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(sk.LAUNCHES, **uk.LAUNCHES, **ov.LAUNCHES)
    per_step = max_launches_per_step(world.settings)
    for name, n in launches.items():
        if n > per_step[name] * steps:
            raise AssertionError(f"[terrain] {name}: {n} launches in "
                                 f"{steps} steps, at most "
                                 f"{per_step[name] * steps}")
    for name in ("solve_iteration_fused", "segment_sum",
                 "ngs_iteration_fused", "relvel_fused", "unified_features",
                 "pair_order", "collide_support"):
        if launches[name] == 0 and torch.device(dev).type == "cuda":
            raise AssertionError(f"[terrain] {name} never launched")
    if launches["count_overlaps"]:
        raise AssertionError("[terrain] K5 launched on the step")

    st = world.state
    ka, kb = mesh_bucket_pairs(st)
    c_local = quat.rotate_inv(st.orn[kb], st.origin_pos()[ka]
                              - st.origin_pos()[kb])
    tris = candidate_tris(st.mesh, st.shape_index[kb], c_local)
    cap = st.mesh.grid.shape[-1]
    n_tri = int((tris >= 0).sum())
    log(f"[terrain] {steps} steps in {t2 - t0:.3f} s = "
        f"{steps / (t2 - t0):.3f} steps/s, "
        f"{1e3 * (t2 - t0) / steps:.2f} ms/step; first {first}: "
        f"{first / (t1 - t0):.3f} steps/s, last {steps - first}: "
        f"{(steps - first) / (t2 - t1):.3f} steps/s "
        f"({1e3 * (t2 - t1) / (steps - first):.2f} ms/step)")
    log(f"[terrain] last step: {len(ka)} live MESH-bucket pairs, "
        f"{len(ka) * cap} (body, triangle) pairs computed, {n_tri} of them "
        f"real candidates; contact rows {rows_in_use(world)}; awake bodies "
        f"{int(st.awake_dynamic.sum())}; overflow "
        f"{world.overflow_counters()}; launches {launches}, per step "
        f"{ {k: v / steps for k, v in launches.items()} }")
    checks = check_terrain(st, body, extent, float(deepest), TERRAIN_FLOOR,
                           "terrain")
    return dict(n_bodies=n_bodies, bodies=st.capacity,
                triangles=len(mesh.indices), steps=steps, seconds=t2 - t0,
                steps_per_s=steps / (t2 - t0),
                ms_per_step=1e3 * (t2 - t0) / steps,
                last_ms_per_step=1e3 * (t2 - t1) / (steps - first),
                mesh_pairs=len(ka), triangle_pairs=len(ka) * cap,
                real_triangle_candidates=n_tri, launches=launches,
                max_pairs=world.meta.max_pairs, **checks), launches, world


def check_terrain(st, body, extent: float, deepest: float, floor,
                  label: str) -> dict:
    """The terrain path's checks: finite state; no body centre beyond the
    walls; every hinge pivot gap under PIVOT_GAP; ``deepest``, the lowest
    centre above the terrain surface of any step, above ``floor``."""
    import torch
    for f in ("pos", "orn", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(st, f)).all()):
            raise AssertionError(f"[{label}] state.{f} is not finite")
    beyond = float(st.pos[body][:, [0, 2]].abs().max()) - extent
    gaps = pivot_gaps(st)
    log(f"[{label}] lowest centre {deepest:.5f} m above the terrain "
        f"surface over all steps (bound {floor}); farthest centre "
        f"{beyond:+.4f} m beyond the walls; pivot gap over {gaps.numel()} "
        f"hinge joints: largest {float(gaps.max()):.5f} m (limit "
        f"{PIVOT_GAP})")
    if beyond > 0.0:
        raise AssertionError(f"[{label}] a body centre left the walls")
    if float(gaps.max()) >= PIVOT_GAP:
        raise AssertionError(f"[{label}] a hinge pivot gap is "
                             f"{float(gaps.max())} m")
    if not deepest > floor:
        raise AssertionError(f"[{label}] a body centre reached "
                             f"{deepest} m above the terrain surface, below "
                             f"{floor}")
    return dict(lowest_above_terrain=deepest, beyond_walls=beyond,
                pivot_gap_max=float(gaps.max()))


# Phase 8: the share of live MESH-bucket pairs that may flip to another
# triangle feature between card and CPU (P2: the UNIFIED bucket gives
# another point set on ~2% of the live manifolds of a settled pile, phase 5)
MESH_FLIP_SHARE = 0.05


def mesh_card_vs_cpu(st, rim: bool) -> dict:
    """Phase 8: the MESH bucket alone, run by the narrowphase's own
    ``bucket_points`` on the live MESH-bucket pairs of a state, on the card
    and from a copy on the CPU. A pair is a feature flip where it has
    another point set (P2): its point validity differs, or a point valid on
    both has another normal (beyond TOL: another triangle or SAT axis won)
    or moved more than POINT_MOVED on either body (another clip feature or
    another four of the candidates kept), as phase 5 counts them. Every
    other pair must agree within TOL on every valid point. Every pair,
    flips included, must keep the parity contract (``parity_contract``),
    and the flips stay under MESH_FLIP_SHARE of the pairs."""
    import torch
    from edyn_tpu_torch.collision import narrowphase as nph
    from edyn_tpu_torch.collision.kernels.support import pack_side_table

    def bucket(s):
        cls, swap, _, _ = nph.live_classes(s, s.contacts)
        rows = (cls == nph.B_MESH).nonzero()[:, 0]
        packed, dims = pack_side_table(s)
        return rows, nph.bucket_points(nph.B_MESH, s, s.contacts, rows, swap,
                                       THRESHOLD, rim, packed, dims)

    rows, got = bucket(st)
    rows_cpu, want = bucket(_to(st, "cpu"))
    if not torch.equal(rows.cpu(), rows_cpu):
        raise AssertionError("[mesh card-vs-cpu] card and CPU select other "
                             "MESH-bucket pairs")
    got = got.cpu()
    K = len(rows_cpu)
    pv_g, pv_w = got[..., 11] > 0.5, want[..., 11] > 0.5
    both = pv_g & pv_w
    over = (got - want).abs() - TOL * (1 + want.abs())       # [K, 4, 14]
    other_normal = (both & (over[..., 6:9] > 0).any(-1)).any(-1)
    moved = (both & ((got - want)[..., 0:6].abs() > POINT_MOVED).any(-1)
             ).any(-1)
    flip = (pv_g != pv_w).any(-1) | other_normal | moved
    far = (both[..., None] & (over > 0)).reshape(K, -1).any(-1)
    bad = far & ~flip
    diff = (got - want).abs()
    names = dict(pivot_a=slice(0, 3), pivot_b=slice(3, 6),
                 normal=slice(6, 9), distance=slice(10, 11),
                 scales=slice(12, 14))
    for k in (bad | flip).nonzero()[:, 0][:12].tolist():
        m = both[k]
        worst = {n: float(diff[k][m][:, c].max()) if bool(m.any()) else None
                 for n, c in names.items()}
        log(f"[mesh card-vs-cpu] pair {k} ({'flip' if flip[k] else 'BAD'}): "
            f"valid card {pv_g[k].tolist()} CPU {pv_w[k].tolist()}; largest "
            f"difference on points valid on both {worst}; CPU distances "
            f"{want[k, :, 10].tolist()}")
    stats = contract_stats(got[..., :12], pv_w, want[..., 10],
                           want[..., 6:9])
    ok = ~flip & ~bad & both.any(-1)
    err = float(diff[ok[:, None, None].expand_as(diff)
                     & both[..., None].expand_as(diff)].max()) \
        if bool(ok.any()) else 0.0
    flips = int(flip.sum())
    n_contact = int(pv_w.any(-1).sum())
    log(f"[mesh card-vs-cpu] {K} live MESH-bucket pairs ({n_contact} with "
        f"points on the CPU): {K - flips - int(bad.sum())} equal within TOL "
        f"(max abs diff {err:.3g}), {flips} feature flips (at most "
        f"{MESH_FLIP_SHARE * K:.0f}), {int(bad.sum())} other; contract "
        f"{stats}")
    if bool(bad.any()):
        raise AssertionError(f"[mesh card-vs-cpu] pairs "
                             f"{bad.nonzero()[:, 0].tolist()} differ beyond "
                             "TOL with the same point set")
    parity_contract(got[..., :12], pv_w, want[..., 10], want[..., 6:9],
                    "mesh card-vs-cpu")
    if flips > MESH_FLIP_SHARE * K:
        raise AssertionError(f"[mesh card-vs-cpu] {flips} of {K} pairs "
                             "flip between card and CPU")
    return dict(pairs=K, with_contact=n_contact, equal=K - flips,
                flips=flips, max_abs_err=err, contract=stats)


VEHICLE_TORQUE = 60.0  # examples/vehicle.py: N*m per wheel about the axle


def vehicle(pkg):
    """examples/vehicle.py's vehicle through a package's public names: a
    compound chassis with a lowered centre of mass on four cylinder wheels
    with hinge joints, on a plane. Returns (builder, chassis, wheels)."""
    import numpy as np
    b = pkg.WorldBuilder()
    b.make_rigidbody(pkg.RigidBodyDef(
        kind=pkg.KIND_STATIC, shape=pkg.PlaneShape((0, 1, 0), 0.0),
        material=pkg.Material(friction=0.9)))
    shape = pkg.CompoundShape(children=[
        (pkg.BoxShape((0.9, 0.18, 0.5)), (0, 0, 0), (0, 0, 0, 1)),
        (pkg.BoxShape((0.4, 0.14, 0.45)), (-0.1, 0.3, 0), (0, 0, 0, 1))])
    r = 0.35
    chassis = b.make_rigidbody(pkg.RigidBodyDef(
        mass=40.0, shape=shape, position=(0, r + 0.25, 0),
        center_of_mass=(0.0, -0.15, 0.0),
        material=pkg.Material(friction=0.4), sleeping_disabled=True))
    q = (0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4))
    wheels = []
    for sx in (0.75, -0.75):
        for sz in (0.65, -0.65):
            w_ = b.make_rigidbody(pkg.RigidBodyDef(
                mass=10.0, shape=pkg.CylinderShape(r, 0.1),
                position=(sx, r, sz), orientation=q,
                material=pkg.Material(friction=1.1, roll_friction=0.002),
                sleeping_disabled=True))
            pkg.make_hinge_constraint(
                b, chassis, w_, pivot_a=(sx, -0.25, sz),
                pivot_b=(0.0, 0.0, 0.0), axis_a=(0, 0, 1), axis_b=(1, 0, 0),
                friction_torque=0.3, damping=0.05, disable_collision=True)
            wheels.append(w_)
    return b, chassis, wheels


def drive_vehicle(dev, frames: int = 120):
    """The vehicle driven ``frames`` frames under the example's wheel
    torque; returns the chassis position of every frame [frames, 3]."""
    import numpy as np
    import edyn_tpu_torch as et
    b, chassis, wheels = vehicle(et)
    w = et.make_world(b, device=dev)
    out = []
    for _ in range(frames):
        for w_ in wheels:
            w.apply_torque_impulse(
                w_, (0.0, 0.0, -VEHICLE_TORQUE * w.settings.fixed_dt))
        w.step(1)
        out.append(w.position(chassis))
    return np.array(out)


def vehicle_card_vs_cpu(dev) -> dict:
    """Phase 8: the vehicle on the card and on the CPU; the chassis must
    pass x = 1.0 m (the example's own assertion) on both."""
    import numpy as np
    card, cpu = drive_vehicle(dev), drive_vehicle("cpu")
    diff = float(np.abs(card - cpu).max())
    log(f"[vehicle] chassis x after {len(card)} frames: card "
        f"{card[-1, 0]:.4f} m, CPU {cpu[-1, 0]:.4f} m; largest difference "
        f"of the two trajectories {diff:.3g} m")
    for name, tr in (("card", card), ("CPU", cpu)):
        if not float(tr[-1, 0]) > 1.0:
            raise AssertionError(f"[vehicle] the vehicle did not drive on "
                                 f"the {name}: x = {tr[-1, 0]}")
    return dict(card_x=float(card[-1, 0]), cpu_x=float(cpu[-1, 0]),
                largest_difference=diff)


def compound_tests_on_card(dev, part: int = 0, parts: int = 1) -> dict:
    """The JAX package's compound behaviour tests (tests/test_compound.py)
    on the card, through the port's test file: every ``parts``-th case
    from ``part``. Returns {case: seconds}."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_compound_behaviour as tb
    out = {}
    for case in tb.CASES[part::parts]:
        t0 = time.perf_counter()
        case(device=dev)
        out[case.__name__] = time.perf_counter() - t0
    return out


COMPOUND_PROCESSES = 3
CALL_THREADS = 2   # CPU threads of each ``start_call`` process


def start_call(fn: str, dev: str, *args):
    """``chip_smoke.<fn>(torch.device(dev), *args)`` in a process of its
    own, on the card beside the main process's checks (work that times
    nothing there): the process, which prints its log and then its JSON
    result as its last line."""
    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1]); "
            f"torch.set_num_threads({CALL_THREADS}); "
            "import chip_smoke; print(json.dumps(getattr(chip_smoke, "
            "sys.argv[2])(torch.device(sys.argv[3]), "
            "*json.loads(sys.argv[4])), default=chip_smoke.json_value), "
            "flush=True)")
    return subprocess.Popen([sys.executable, "-c", code, ROOT, fn, dev,
                             json.dumps(args)], cwd=ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def json_value(x):
    """``json.dumps``' default for numpy and torch scalars."""
    return x.item() if hasattr(x, "item") else str(x)


def stop_calls(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_calls(procs, timeout: float = 900.0) -> list:
    """Wait for ``start_call``'s processes, print their logs and return
    their results; fail if one failed."""
    out = []
    try:
        for proc in procs:
            text, _ = proc.communicate(timeout=timeout)
            if proc.returncode != 0:
                raise AssertionError(f"[{proc.args[4]}] failed on the card "
                                     f"({proc.returncode}):\n{text[-4000:]}")
            lines = text.strip().splitlines()
            for line in lines[:-1]:
                print(line, flush=True)
            out.append(json.loads(lines[-1]))
    finally:
        stop_calls(procs)
    return out


def beside(calls, work):
    """``work()`` in this process while each of ``calls`` ((function name,
    device, *args)) runs in a process of its own (``start_call``). Returns
    (work's result, the calls' results in order); fails if any failed."""
    procs = [start_call(*c) for c in calls]
    try:
        out = work()
    except BaseException:
        stop_calls(procs)
        raise
    return out, finish_calls(procs)


def terrain_checks(dev, calls=()) -> tuple:
    """Phase 8: card against CPU on rich_scene(512) settled 240 steps, each
    body held to its own 1-ulp sensitivity with positions and orientations
    nudged (ROADMAP P7); the MESH bucket alone; the opt-in triangle cull
    (P9). Beside them, each in a process of its own: the vehicle, the JAX
    package's compound tests on the card in COMPOUND_PROCESSES shares, and
    ``calls``. Returns (summary, the results of ``calls``)."""
    from edyn_tpu_torch.shapes.params import ShapeType
    from edyn_tpu_torch.utils.scenes import rich_scene

    def work():
        builder = rich_scene(n_bodies=512)[0]
        mesh = builder.defs[0].shape
        out = {}
        out["card_vs_cpu"], w8 = card_vs_cpu(
            dev, builder=builder, label="terrain card-vs-cpu",
            nudge_orn=True)
        rim = ShapeType.CYLINDER in w8.meta.types_present
        out["mesh_card_vs_cpu"] = mesh_card_vs_cpu(w8.state, rim)
        out["mesh_cull"] = mesh_cull_check(w8, mesh)
        return out
    n = COMPOUND_PROCESSES
    out, res = beside([("compound_tests_on_card", "cuda", i, n)
                       for i in range(n)]
                      + [("vehicle_card_vs_cpu", "cuda")] + list(calls), work)
    compound = {}
    for part in res[:n]:
        compound.update(part)
    log(f"[compound tests] passed on the card ({n} processes of their "
        f"own): { {k: round(v, 2) for k, v in compound.items()} } s")
    out["compound_tests"] = compound
    out["vehicle"] = res[n]
    return out, res[n + 1:]


def mesh_cull_check(world, mesh) -> dict:
    """Phase 8, ROADMAP P9: the settled rich_scene(512) with the opt-in
    ``Settings.mesh_triangle_cull``. The MESH bucket's points on the same
    state with the cull off and on. A point beside its body (R10) is one
    whose point on the triangle lies farther than the collision threshold
    from the body's AABB; one the cull removed is beside its body without
    the cull and has no point of its pair within 1e-6 m with it. Printed:
    the points beside their bodies with and without the cull, the count
    the cull removed and the smallest distance from such a point to its
    body's AABB. Then one whole step with the cull on and one without:
    finite, and no body past TERRAIN_FLOOR (phase 7's bound) but those
    already past it before the step (by step 240 the bodies the terrain
    lost, R11, are in free fall far below it)."""
    import torch
    from edyn_tpu_torch.collision import narrowphase as nph
    from edyn_tpu_torch.collision.kernels.support import pack_side_table
    from edyn_tpu_torch.math import quat
    from edyn_tpu_torch.shapes.params import ShapeType
    from edyn_tpu_torch.simulation.stepper import physics_step

    st = world.state
    rim = ShapeType.CYLINDER in world.meta.types_present
    cls, swap, _, _ = nph.live_classes(st, st.contacts)
    rows = (cls == nph.B_MESH).nonzero()[:, 0]
    packed, dims = pack_side_table(st)
    pts = {c: nph.bucket_points(nph.B_MESH, st, st.contacts, rows, swap,
                                THRESHOLD, rim, packed, dims, c)
           for c in (False, True)}
    sw = swap[rows][:, None, None]
    a, b = st.contacts.body_a[rows].long(), st.contacts.body_b[rows].long()
    mesh_b = torch.where(swap[rows], a, b)
    body = torch.where(swap[rows], b, a)

    def on_triangle(p):        # [K, 4, 3] world points on the mesh side
        local = torch.where(sw, p[..., 0:3], p[..., 3:6])
        return (quat.rotate(st.orn[mesh_b][:, None, :], local)
                + st.origin_pos()[mesh_b][:, None, :])

    off, on = pts[False], pts[True]
    pv_off, pv_on = off[..., 11] > 0.5, on[..., 11] > 0.5
    p_off, p_on = on_triangle(off), on_triangle(on)
    near = ((p_off[:, :, None, :] - p_on[:, None, :, :]).abs().amax(-1)
            <= 1e-6) & pv_on[:, None, :]
    lo = st.aabb_min[body][:, None, :]
    hi = st.aabb_max[body][:, None, :]

    def gap(p):
        return torch.linalg.vector_norm(torch.clamp(
            torch.maximum(lo - p, p - hi), min=0.0), dim=-1)

    beside_off = pv_off & (gap(p_off) > THRESHOLD)
    beside_on = pv_on & (gap(p_on) > THRESHOLD)
    removed = beside_off & ~near.any(-1)
    gap = gap(p_off)
    n_removed = int(removed.sum())
    nearest = float(gap[removed].min()) if n_removed else None
    clearance = terrain_clearance(mesh, st.device)
    dyn = st.is_dynamic
    lost = clearance(st.pos[dyn]) <= TERRAIN_FLOOR
    past = {}
    for cull in (False, True):
        after = physics_step(st, world.settings.replace(
            mesh_triangle_cull=cull), world.meta)
        for f in ("pos", "orn", "linvel", "angvel"):
            if not bool(torch.isfinite(getattr(after, f)).all()):
                raise AssertionError(f"[mesh cull] state.{f} is not finite")
        h = clearance(after.pos[dyn])
        past[cull] = int((h <= TERRAIN_FLOOR).sum())
        if bool(((h <= TERRAIN_FLOOR) & ~lost).any()):
            raise AssertionError(f"[mesh cull] a body passed {TERRAIN_FLOOR}"
                                 f" m in one step (cull {cull})")
        if cull:
            lowest = float(h[~lost].min())
    log(f"[mesh cull] {len(rows)} live MESH-bucket pairs: "
        f"{int(pv_off.sum())} points without the cull, {int(pv_on.sum())} "
        f"with it; beside their bodies {int(beside_off.sum())} without, "
        f"{int(beside_on.sum())} with; {n_removed} removed, the nearest of "
        f"them {nearest} m from its body's AABB; one step with the cull: "
        f"finite, {past[True]} bodies past {TERRAIN_FLOOR} m (without it "
        f"{past[False]}, before the step {int(lost.sum())}: the bodies the "
        f"terrain lost, R11), the lowest of the others {lowest:.5f} m "
        f"above the terrain surface")
    return dict(pairs=len(rows), points=int(pv_off.sum()),
                points_with_cull=int(pv_on.sum()),
                beside=int(beside_off.sum()),
                beside_with_cull=int(beside_on.sum()), removed=n_removed,
                nearest_removed_m=nearest, lost_before=int(lost.sum()),
                past_floor_after_step=past[True],
                past_floor_without_cull=past[False],
                lowest_after_step=lowest)


# Phase 9: bench.py's protocol (bench_size, bench.py:86-148) on the port
BENCH_STEPS = 60       # bench.py N_STEPS
BENCH_SETTLE = 300     # bench.py SETTLE_STEPS
BENCH_CHUNK = 30       # bench.py CALL_CHUNK
SPARE_SLOTS = 256
MIN_ASLEEP = 0.9       # bench.py's validity rule (it only warns)
N_RAYS_SIDE = 64       # 4,096 vertical rays
RAY_TIE = 1e-5         # fraction within which two hits are a tie
RAY_NORMAL_TOL = 1e-4


def _run_steps(world, n):
    done = 0
    while done < n:
        k = min(BENCH_CHUNK, n - done)
        world.step_n(k)
        done += k
    world.block_until_ready()


def _time_steps(world, n):
    t0 = time.perf_counter()
    _run_steps(world, n)
    return n / (time.perf_counter() - t0)


def _check_world(world, label: str):
    """Finite state and every overflow counter zero."""
    import torch
    st = world.state
    for f in ("pos", "orn", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(st, f)[st.valid]).all()):
            raise AssertionError(f"[{label}] state.{f} is not finite")
    ovf = world.overflow_counters()
    if any(ovf.values()):
        raise AssertionError(f"[{label}] overflow counters {ovf}")


def _reset_counts():
    from edyn_tpu_torch.collision.kernels import merge_kernel as mk
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    from edyn_tpu_torch.ops import overlap_count as ov
    sk.reset_launch_counts()
    uk.reset_launch_counts()
    ov.reset_launch_counts()
    mk.reset_launch_counts()


def _read_counts() -> dict:
    from edyn_tpu_torch.collision.kernels import merge_kernel as mk
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    from edyn_tpu_torch.ops import overlap_count as ov
    return dict(sk.LAUNCHES, **uk.LAUNCHES, **ov.LAUNCHES, **mk.LAUNCHES)


def asleep_path(n_bodies: int, dev):
    """Phase 9: bench.py's sequence on the port's 10k pile, built with
    SPARE_SLOTS spare slots: step_n(2), BENCH_STEPS falling steps timed,
    BENCH_SETTLE untimed, BENCH_STEPS settled steps timed; then the
    mostly-asleep set-up of bench.py:111-148 line for line and
    BENCH_STEPS mostly-asleep steps timed. Launch counts are set to 0
    before step_n(2) and read after the last step; those of the
    mostly-asleep steps alone too. Fails below MIN_ASLEEP asleep, on a
    non-finite state or a non-zero overflow counter. Returns (summary,
    launches over the protocol, launches over the mostly-asleep steps,
    world, ids)."""
    import dataclasses
    import numpy as np
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.dynamics.islands import RESET_PERIOD
    from edyn_tpu_torch.simulation.stepper import prepare_rows, solve_width
    from edyn_tpu_torch.utils.scenes import mixed_pile

    builder, ids = mixed_pile(n_bodies=n_bodies)
    world = et.make_world(builder, et.Settings(),
                          capacity=len(builder.defs) + SPARE_SLOTS,
                          device=dev)
    _reset_counts()
    t0 = time.perf_counter()
    world.step_n(2)
    world.block_until_ready()
    first_call = time.perf_counter() - t0
    falling = _time_steps(world, BENCH_STEPS)
    _check_world(world, "bench falling")
    _run_steps(world, BENCH_SETTLE)
    settled = _time_steps(world, BENCH_STEPS)
    _check_world(world, "bench settled")

    world.put_to_sleep()
    n_active = min(100, n_bodies // 10)
    st = world.state
    # host read: the bench picks the bodies to relaunch on the host
    pos = st.pos.cpu().numpy()
    ids_arr = np.asarray(ids, np.int64)
    act = ids_arr[np.argsort(-pos[ids_arr, 1])[:n_active]]
    top = float(pos[st.is_dynamic.cpu().numpy()][:, 1].max())
    g = int(np.ceil(np.sqrt(n_active)))
    newpos = pos.copy()
    for k, e in enumerate(act):
        newpos[e] = ((k % g) * 1.2 - g * 0.6, top + 25.0 + (k // g) * 1.2,
                     (k // g) * 1.2 - g * 0.6)
    world.state = dataclasses.replace(
        st, pos=torch.as_tensor(newpos, dtype=st.pos.dtype, device=dev))
    world.wake_set(set(act.tolist()))
    world.step_n(2)
    world.step_n(RESET_PERIOD + 2)
    world.put_to_sleep()
    world.wake_set(set(act.tolist()))
    world.step_n(1)
    world.block_until_ready()
    st = world.state
    asleep_frac = float(st.asleep.sum()) / max(1, int(st.is_dynamic.sum()))
    log(f"[bench] asleep_fraction {asleep_frac:.4f} after the set-up "
        f"({n_active} bodies relaunched {top + 25.0:.2f} m up)")
    if asleep_frac < MIN_ASLEEP:
        raise AssertionError(f"[bench] asleep_fraction {asleep_frac} < "
                             f"{MIN_ASLEEP}: the mostly-asleep phase is "
                             "not mostly asleep")
    before = _read_counts()
    with MergeWatch("mostly asleep") as watch:
        mostly = _time_steps(world, BENCH_STEPS)
    launches = _read_counts()
    asleep_launches = {k: launches[k] - before[k] for k in launches}
    _check_world(world, "bench mostly asleep")
    merge = watched_merges(watch, "mostly asleep")
    st, _, rows, _ = prepare_rows(world.state, world.settings, world.meta)
    width = solve_width(rows, world.meta)
    full = rows.valid.shape[0]
    log(f"[bench] steps/s falling {falling:.3f}, settled {settled:.3f}, "
        f"mostly asleep {mostly:.3f}; first call (2 steps) "
        f"{first_call:.2f} s; rows.count {int(rows.count)}, solve width "
        f"{width} of {full} (R/8 = {full // 8}); max_pairs "
        f"{world.meta.max_pairs}; launches over the protocol {launches}, "
        f"over the mostly-asleep steps {asleep_launches}")
    if not width < full:
        raise AssertionError("[bench] the mostly-asleep step solves the full "
                             "row table")
    # the protocol runs every kernel of the step; the mostly-asleep steps
    # at least the solver's (their awake bodies may have no pair)
    on_card = torch.device(dev).type == "cuda"
    for name in ("solve_iteration_fused", "ngs_iteration_fused",
                 "restitution_iteration_fused", "segment_sum",
                 "relvel_fused", "unified_features", "pair_order",
                 "collide_support"):
        if on_card and not launches[name]:
            raise AssertionError(f"[bench] {name} never launched")
    no_unfused(launches, "bench")
    for name in ("solve_iteration_fused", "segment_sum",
                 "ngs_iteration_fused", "relvel_fused"):
        if on_card and not asleep_launches[name]:
            raise AssertionError(f"[bench] {name} never launched in the "
                                 "mostly-asleep steps")
    if launches["count_overlaps"]:
        raise AssertionError("[bench] K5 launched on the step")
    return dict(bodies=n_bodies, capacity=world.state.capacity,
                falling_steps_per_s=falling, settled_steps_per_s=settled,
                mostly_asleep_steps_per_s=mostly,
                asleep_fraction=asleep_frac, first_call_s=first_call,
                rows_count=int(rows.count), solve_width=width,
                full_width=full, max_pairs=world.meta.max_pairs,
                launches=launches, asleep_launches=asleep_launches,
                merge=merge), \
        launches, asleep_launches, world, ids


def live_api(world, ids, dev) -> dict:
    """Phase 9, second part: the live-world API at full width on the
    mostly-asleep 10k world. Spawns SPARE_SLOTS bodies of the pile's five
    shapes just above the pile, moving down, into the spare slots;
    destroys as many others; applies an impulse, a kind change there and
    back, a shape change, a collision exclusion and a gravity change to a
    few bodies each; steps 10 times through ``step_with_events``, every
    spawned body that ends touching something having a started contact;
    casts 4,096 vertical rays over the pile on the card and on a CPU copy
    of the state (the entity equal, the fraction within RAY_TIE and the
    normal within RAY_NORMAL_TOL, where the entity differs the two
    fractions within RAY_TIE: a tie in entry time); and holds
    ``query_aabb`` to a numpy brute force."""
    import numpy as np
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.core.convert import state_from_numpy, state_to_numpy
    from edyn_tpu_torch.collision.raycast import raycast

    rng = np.random.default_rng(5)
    st = world.state
    # host reads: the scene's geometry picks where the bodies go
    pos = st.pos.cpu().numpy()
    pile = np.asarray(ids)[pos[ids, 1] < 5.0]
    lo_xz = pos[pile][:, [0, 2]].min(0)
    hi_xz = pos[pile][:, [0, 2]].max(0)
    tet = et.PolyhedronShape(np.array(
        [[0.15, 0.15, 0.15], [0.15, -0.15, -0.15],
         [-0.15, 0.15, -0.15], [-0.15, -0.15, 0.15]], np.float32))
    shapes = [et.SphereShape(0.15), et.BoxShape((0.15, 0.12, 0.18)),
              et.CapsuleShape(0.1, 0.15), et.CylinderShape(0.12, 0.15), tet]
    free = int((~st.valid).sum())
    t0 = time.perf_counter()
    spawned = []
    xz = rng.uniform(lo_xz + 1.0, hi_xz - 1.0, (SPARE_SLOTS, 2))
    for k in range(SPARE_SLOTS):
        near = pile[np.abs(pos[pile][:, [0, 2]] - xz[k]).max(1) < 0.6]
        y = (pos[near, 1].max() if len(near) else 0.0) + 0.5
        spawned.append(world.spawn(et.RigidBodyDef(
            mass=1.0, shape=shapes[k % 5], position=(xz[k, 0], y, xz[k, 1]),
            linvel=(0.0, -4.0, 0.0),
            material=et.Material(friction=0.5, restitution=0.2,
                                 roll_friction=0.005)),
            poly_index=0 if k % 5 == 4 else None))
    t_spawn = time.perf_counter() - t0
    if free < SPARE_SLOTS or len(set(spawned)) != SPARE_SLOTS:
        raise AssertionError(f"[live] {free} free slots, spawned into "
                             f"{len(set(spawned))}")
    doomed = rng.choice(pile, SPARE_SLOTS, replace=False)
    t0 = time.perf_counter()
    for i in doomed:
        world.destroy(int(i))
    t_destroy = time.perf_counter() - t0
    some = rng.choice(np.setdiff1d(pile, doomed), 12, replace=False)
    world.apply_impulse(int(some[0]), (0.0, 3.0, 0.0), (0.05, 0.0, 0.0))
    world.set_kind(int(some[1]), et.KIND_STATIC)
    world.set_kind(int(some[1]), et.KIND_DYNAMIC, mass=1.0)
    world.set_kind(int(some[2]), et.KIND_STATIC)
    world.set_shape(int(some[3]), et.SphereShape(0.12))
    world.exclude_collision(int(some[4]), int(some[5]))
    world.set_gravity((0.0, -12.0, 0.0), int(some[6]))
    world.set_gravity((0.0, -9.81, 0.0))
    started, ended = set(), set()
    t0 = time.perf_counter()
    for _ in range(10):
        s_, e_ = world.step_with_events(1)
        started |= set(s_)
        ended |= set(e_)
    world.block_until_ready()
    t_events = time.perf_counter() - t0
    _check_world(world, "live")
    st = world.state
    man = st.contacts
    touching = (man.valid & man.point_valid.any(1)).cpu().numpy()
    ba, bb = man.body_a.cpu().numpy(), man.body_b.cpu().numpy()
    spawned_set = set(spawned)
    landed = {int(x) for a, b in zip(ba[touching], bb[touching])
              for x in (a, b) if int(x) in spawned_set}
    reported = {int(x) for p in started for x in p if int(x) in spawned_set}
    log(f"[live] spawned {SPARE_SLOTS} in {t_spawn:.2f} s, destroyed "
        f"{SPARE_SLOTS} in {t_destroy:.2f} s; 10 steps through "
        f"step_with_events in {t_events:.2f} s: {len(started)} started, "
        f"{len(ended)} ended; {len(landed)} spawned bodies touching, "
        f"{len(reported)} of the spawned with a started contact")
    if not landed <= reported:
        raise AssertionError(f"[live] spawned bodies "
                             f"{sorted(landed - reported)[:10]} touch with "
                             "no started contact")
    if len(landed) < SPARE_SLOTS // 4:
        raise AssertionError(f"[live] only {len(landed)} spawned bodies "
                             "landed")
    if bool(st.valid[torch.as_tensor(doomed, device=dev)].any()):
        raise AssertionError("[live] a destroyed body is valid")

    # rays: a grid over the pile's footprint, from 1 m above the pile's
    # highest AABB (the relaunched bodies fly higher) to below the floor;
    # far starts cost float32 precision in every ray-shape test (|p0|^2
    # against r^2), on either device
    pos = st.pos.cpu().numpy()
    valid = st.valid.cpu().numpy()
    in_pile = valid & (pos[:, 1] < 5.0) & st.is_dynamic.cpu().numpy()
    top = float(st.aabb_max[torch.as_tensor(in_pile, device=dev)][:, 1]
                .max()) + 1.0
    gx = np.linspace(lo_xz[0], hi_xz[0], N_RAYS_SIDE)
    gz = np.linspace(lo_xz[1], hi_xz[1], N_RAYS_SIDE)
    X, Z = np.meshgrid(gx, gz, indexing="ij")
    p0 = np.stack([X.ravel(), np.full(X.size, top), Z.ravel()],
                  1).astype(np.float32)
    p1 = (p0 * [1, 0, 1] + [0, -0.5, 0]).astype(np.float32)
    t0 = time.perf_counter()
    card = world.raycast(p0, p1)
    t_ray = time.perf_counter() - t0
    st_cpu = state_from_numpy(state_to_numpy(st), "cpu")
    cpu = {k: v.numpy() for k, v in raycast(
        st_cpu, torch.as_tensor(p0), torch.as_tensor(p1)).items()}
    if not (card["entity"] >= 0).all():
        raise AssertionError(f"[live] {(card['entity'] < 0).sum()} rays "
                             "from above the pile miss")
    if not valid[card["entity"]].all():
        raise AssertionError("[live] a ray hit an invalid body")
    dfrac = np.abs(card["fraction"] - cpu["fraction"])
    other = ((card["entity"] != cpu["entity"])
             | (np.abs(card["normal"] - cpu["normal"]).max(1)
                > RAY_NORMAL_TOL))
    log(f"[live] {p0.shape[0]} rays of {top + 0.5:.2f} m in "
        f"{t_ray * 1e3:.1f} ms on the card; against the CPU: max fraction "
        f"difference {dfrac.max():.3g}, {int(other.sum())} rays with "
        f"another entity or normal (each must be a tie: fraction within "
        f"{RAY_TIE})")
    for q in np.nonzero(other | (dfrac > RAY_TIE))[0][:12]:
        log(f"[live] ray {q}: card entity {card['entity'][q]} fraction "
            f"{card['fraction'][q]!r} normal {card['normal'][q].tolist()}, "
            f"CPU entity {cpu['entity'][q]} fraction {cpu['fraction'][q]!r} "
            f"normal {cpu['normal'][q].tolist()}")
    if not (dfrac <= RAY_TIE).all():
        raise AssertionError(f"[live] card and CPU raycast fractions differ "
                             f"by {dfrac.max()}")
    # the same grid from 5 m above every body (the relaunched ones too):
    # far starts lose float32 precision in the ray-shape tests of both
    # packages (ROADMAP R12), which shows here as card-CPU differences;
    # printed, not held
    far0 = p0.copy()
    far0[:, 1] = float(pos[valid][:, 1].max()) + 5.0
    card_far = world.raycast(far0, p1)
    cpu_far = {k: v.numpy() for k, v in raycast(
        st_cpu, torch.as_tensor(far0), torch.as_tensor(p1)).items()}
    length = float(far0[0, 1] - p1[0, 1])
    far_m = float(np.abs(card_far["fraction"]
                         - cpu_far["fraction"]).max()) * length
    far_other = int((card_far["entity"] != cpu_far["entity"]).sum())
    log(f"[live] R12: the grid cast from {length:.2f} m up: card and CPU "
        f"hits up to {far_m:.3g} m apart, {far_other} rays with another "
        "entity")

    amin, amax = st.aabb_min.cpu().numpy(), st.aabb_max.cpu().numpy()
    for _ in range(8):
        c = rng.uniform([lo_xz[0], 0.0, lo_xz[1]], [hi_xz[0], 3.0, hi_xz[1]])
        h = rng.uniform(0.2, 3.0, 3)
        for inc in (True, False):
            want = (amin <= c + h).all(1) & (amax >= c - h).all(1) & valid
            if not inc:
                want &= st.is_dynamic.cpu().numpy()
            got = world.query_aabb(c - h, c + h, inc)
            if got != np.nonzero(want)[0].tolist():
                raise AssertionError("[live] query_aabb differs from the "
                                     "brute force")
    return dict(spawned=SPARE_SLOTS, destroyed=SPARE_SLOTS,
                spawn_s=t_spawn, destroy_s=t_destroy, events_s=t_events,
                started=len(started), ended=len(ended),
                spawned_touching=len(landed), rays=int(p0.shape[0]),
                ray_ms=t_ray * 1e3, ray_max_fraction_diff=float(dfrac.max()),
                ray_ties=int(other.sum()), far_ray_m=length,
                far_ray_max_diff_m=far_m, far_ray_other_entity=far_other)


# Phase 10: PagedTerrain streaming on the card
PAGED_CELLS = 128      # grid_mesh(129, 129, 1.0): 32,768 triangles
PAGED_TILE = 8.0       # 256 tiles
PAGED_POOL = 32
PAGED_STEPS = 240
CONVOY_SIDE = 8        # 64 bodies, 1.5 m apart
CONVOY_SPEED = 8.0


def paged_path(dev):
    """Phase 10: a streaming PagedTerrain (PAGED_POOL slots, page caches in
    a temporary directory, the prefetch thread on) under a convoy of 64
    spheres and boxes launched diagonally across it, stepped PAGED_STEPS
    times with ``update()`` after each step. Fails if a body's centre falls
    below the terrain surface at its (x, z), if no page loads or unloads
    after the first frame, if more than PAGED_POOL pages are resident, or if
    a wanted page is refused for want of a slot. Then the pool table on the
    card must be bit-equal to the table the CPU path writes for the same
    tile writes. Returns (summary, launches)."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.shapes.mesh import MeshTable
    from edyn_tpu_torch.shapes.paged import PagedTerrain
    from edyn_tpu_torch.utils.scenes import grid_mesh, terrain_height

    verts, tris = grid_mesh(PAGED_CELLS + 1, PAGED_CELLS + 1, 1.0,
                            height_fn=terrain_height)
    with tempfile.TemporaryDirectory() as cache:
        t0 = time.perf_counter()
        b = et.WorldBuilder()
        terrain = PagedTerrain(b, verts, tris, tile_size=PAGED_TILE,
                               pool_slots=PAGED_POOL, cache_dir=cache)
        t_bake = time.perf_counter() - t0
        d = np.array([1.0, 0.0, 1.0]) / np.sqrt(2.0)
        start = -0.35 * PAGED_CELLS
        convoy = []
        for i in range(CONVOY_SIDE):
            for j in range(CONVOY_SIDE):
                x = start + 1.5 * i
                z = start + 1.5 * j
                k = i * CONVOY_SIDE + j
                shape = (et.SphereShape(0.3) if k % 2 == 0
                         else et.BoxShape((0.3, 0.25, 0.3)))
                convoy.append(b.make_rigidbody(et.RigidBodyDef(
                    mass=1.0, shape=shape,
                    position=(x, float(terrain_height(x, z)) + 0.4, z),
                    linvel=tuple(CONVOY_SPEED * d),
                    material=et.Material(friction=0.02, roll_friction=0.0),
                    sleeping_disabled=True)))
        world = et.make_world(b, device=dev)
        terrain.attach(world)
        tiles = len(terrain.bodies)
        body = torch.as_tensor(convoy, device=dev)
        clearance = terrain_clearance(et.MeshShape(verts, tris), dev)
        deepest = torch.full((), float("inf"), device=dev,
                             dtype=torch.float64)
        terrain.update()
        first_loads = len(terrain.writes)
        loads, unloads = 0, 0
        peak = terrain.resident_slots_used
        upd = []
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PAGED_STEPS):
            world.step()
            t1 = time.perf_counter()
            n_in, n_out = terrain.update()
            upd.append(time.perf_counter() - t1)
            loads += n_in
            unloads += n_out
            peak = max(peak, terrain.resident_slots_used)
            deepest = torch.minimum(
                deepest, clearance(world.state.pos[body]).min())
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        terrain.stop()
        launches = _read_counts()
    _check_world(world, "paged")
    deepest = float(deepest)
    st = world.state
    travelled = float((st.pos[body][:, [0, 2]].mean(0).cpu()
                       - torch.tensor([start + 5.25] * 2)).norm())
    log(f"[paged] {tiles} pages of {PAGED_TILE} m over a "
        f"{PAGED_CELLS} m square ({len(tris)} triangles), baked to "
        f"{tiles} page caches in {t_bake:.2f} s; pool {PAGED_POOL} slots; "
        f"first frame {first_loads} loads; then {PAGED_STEPS} steps in "
        f"{t_all:.3f} s = {PAGED_STEPS / t_all:.3f} steps/s, update() "
        f"{1e3 * statistics.mean(upd):.3f} ms a frame (median "
        f"{1e3 * statistics.median(upd):.3f}, max {1e3 * max(upd):.3f}); "
        f"{loads} loads, {unloads} unloads, peak {peak} resident, "
        f"{terrain.refused_loads} refused, {terrain.prefetch_misses} "
        f"prefetch misses; convoy moved {travelled:.2f} m; lowest centre "
        f"{deepest:.5f} m above the surface; launches {launches}")
    if deepest < 0.0:
        raise AssertionError(f"[paged] a centre fell {-deepest} m below the "
                             "terrain surface")
    if not (loads and unloads):
        raise AssertionError("[paged] no page loaded or unloaded after the "
                             "first frame")
    if peak > PAGED_POOL:
        raise AssertionError(f"[paged] {peak} pages resident")
    if terrain.refused_loads:
        raise AssertionError(f"[paged] {terrain.refused_loads} wanted pages "
                             "refused for want of a slot")
    # the CPU path's table for the same tile writes
    with tempfile.TemporaryDirectory() as cache2:
        t2 = PagedTerrain(et.WorldBuilder(), verts, tris,
                          tile_size=PAGED_TILE, pool_slots=PAGED_POOL,
                          cache_dir=cache2, prefetch=False)
        table = t2.make_pool_table("cpu")
        for slot, k in terrain.writes:
            table = t2.write_rows(table, slot, t2.tile_rows(k))
    for f in (f.name for f in dataclasses.fields(MeshTable)):
        if not torch.equal(getattr(st.mesh, f).cpu(), getattr(table, f)):
            raise AssertionError(f"[paged] the card's pool table differs "
                                 f"from the CPU's in {f}")
    log(f"[paged] pool table bit-equal to the CPU path's after "
        f"{len(terrain.writes)} tile writes")
    return dict(pages=tiles, triangles=len(tris), pool_slots=PAGED_POOL,
                steps=PAGED_STEPS, seconds=t_all,
                steps_per_s=PAGED_STEPS / t_all,
                update_ms_mean=1e3 * statistics.mean(upd),
                update_ms_median=1e3 * statistics.median(upd),
                update_ms_max=1e3 * max(upd), first_frame_loads=first_loads,
                loads=loads, unloads=unloads, peak_resident=peak,
                refused=terrain.refused_loads,
                prefetch_misses=terrain.prefetch_misses,
                tile_writes=len(terrain.writes), lowest_above=deepest,
                travelled_m=travelled, launches=launches), launches


# Phase 11: the networked path (checkpoint, server and clients over bytes,
# the async worker, presentation) on the 10k pile
NET_LAND = 120          # steps that land the pile before the phase
NET_RESUME = 30         # steps the live and the resumed world take
NET_FRAMES = 120        # frames at 60 Hz, one server step each
NET_LOSS = 0.1          # share of unreliable packets lost on every channel
NET_DELAY = 3           # frames each way on the player's link (100 ms RTT)
PLAYER_HALF = 8.0       # the player's interest box half extents, m
ASYNC_SECONDS = 2.0
ASYNC_IMPULSES = 64
PRES_FRAMES = 30        # render frames at 30 fps over 60 Hz steps
TRANSFORMS = ("pos", "orn", "linvel", "angvel")


class NetChannel:
    """A transport that carries only bytes (``encode_packet``/
    ``decode_packet``): unreliable packets are lost at ``loss`` (seeded),
    every packet arrives ``delay`` frames after it was sent. Counts the
    bytes sent and the packets decoded, and the seconds ``handler`` took
    per packet type."""

    def __init__(self, loss: float, seed: int, delay: int = 0):
        import numpy as np
        self.loss, self.delay = loss, delay
        self.rng = np.random.RandomState(seed)
        self.frame = 0
        self.queue = []
        self.sent_bytes = 0
        self.decoded = 0
        self.handle_s = {}
        self.last = {}      # packet type -> (frame, packet) last delivered

    def send(self, packet):
        from edyn_tpu_torch.networking import packets as pk
        from edyn_tpu_torch.networking.wire import encode_packet
        raw = encode_packet(packet)
        self.sent_bytes += len(raw)
        if not pk.should_send_reliably(packet) and \
                self.rng.rand() < self.loss:
            return
        self.queue.append((self.frame + self.delay, raw))

    def drain(self, handler, now):
        from edyn_tpu_torch.networking.wire import decode_packet
        due = [r for f, r in self.queue if f <= self.frame]
        self.queue = [(f, r) for f, r in self.queue if f > self.frame]
        for raw in due:
            p = decode_packet(raw)
            self.decoded += 1
            kind = type(p).__name__
            t0 = time.perf_counter()
            handler(p, now)
            self.handle_s[kind] = self.handle_s.get(kind, 0.0) + (
                time.perf_counter() - t0)
            self.last[kind] = (self.frame, p)


def _emptied(world):
    """``world`` with every body destroyed in one write of each column
    (its tables, widths and polyhedra stay: a client world that can take
    the server's shapes)."""
    import torch
    from edyn_tpu_torch.core.spawn import destroy_rigidbody
    st = world.state
    world.state = destroy_rigidbody(st, torch.arange(
        st.capacity, device=st.device))
    world._reset_island_stability()
    return world


def _sync():
    import torch
    torch.cuda.synchronize()


def networked_path(dev):
    """Phase 11 on ``mixed_pile(N_BODIES)`` with a ``"steer"`` user
    component (``replicate="input"``) and SPARE_SLOTS spare slots, landed
    by NET_LAND steps; launch counts set to 0 before the phase and read
    after it.

    11a. ``world_to_bytes`` the landed world, ``resume_world`` the bytes on
    the card, step both NET_RESUME steps: pos, orn, linvel, angvel and the
    contact keys bit-equal; the same bytes loaded on the CPU equal, leaf
    for leaf, the card's resumed state before it stepped.
    11b. A ``NetworkServer`` on the live world and two clients over
    ``NetChannel``s (NET_LOSS): a spectator (the default 50 m box, no
    extrapolation, its world on the card) and a player that creates a
    sphere 2 m above the pile, records a ``"steer"`` input every frame,
    follows the sphere with a PLAYER_HALF box over a NET_DELAY-frame link,
    replays snapshots on the background worker and steps its world every
    frame (both clients' worlds are the pile's, emptied; the player's with
    ``Settings(pool_convex_rows=True)``, ROADMAP R13). NET_FRAMES frames:
    every packet decodes; the spectator maps every entity of its interest
    set; its transforms of the last delivered transient snapshot's
    entities equal the server's at that frame bit for bit; the player's
    sphere is on the server with a recorded ``"steer"``; the extrapolation
    worker is alive and has replayed; every world's counters are zero.
    11c. ``AsyncSimulation`` on the live world for ASYNC_SECONDS, with
    ASYNC_IMPULSES impulses and 4,096 ``raycast_async`` calls queued: the
    thread alive and stepping before ``stop()``, every ray answered, on
    the main thread's stream, the state finite, the counters zero.
    11d. ``Presentation`` at 30 fps over 60 Hz steps for PRES_FRAMES
    frames: every ``transforms()`` finite. Returns (summary, launches)."""
    import dataclasses
    import numpy as np
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.core.convert import state_to_numpy
    from edyn_tpu_torch.networking import NetworkClient, NetworkServer
    from edyn_tpu_torch.networking.wire import varint_encoder
    from edyn_tpu_torch.serialization.checkpoint import (
        resume_world, world_from_bytes, world_to_bytes,
    )
    from edyn_tpu_torch.simulation.async_worker import AsyncSimulation
    from edyn_tpu_torch.simulation.presentation import Presentation
    from edyn_tpu_torch.utils.scenes import mixed_pile

    def pile_world(settings=et.Settings()):
        builder, ids = mixed_pile(n_bodies=N_BODIES)
        builder.register_component("steer", replicate="input")
        return et.make_world(builder, settings,
                             capacity=len(builder.defs) + SPARE_SLOTS,
                             device=dev), ids

    out = {}
    _reset_counts()
    world, ids = pile_world()
    _run_steps(world, NET_LAND)
    _check_world(world, "net landed")

    # 11a. checkpoint resume
    t0 = time.perf_counter()
    blob = world_to_bytes(world.state, world.settings, world.meta)
    save_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    resumed = resume_world(blob, device=dev)
    _sync()
    load_ms = 1e3 * (time.perf_counter() - t0)
    if resumed.meta != world.meta:
        raise AssertionError(f"[net] resumed meta {resumed.meta} != live "
                             f"{world.meta}")
    t0 = time.perf_counter()
    cpu_state, _ = world_from_bytes(blob, device="cpu")
    cpu_load_ms = 1e3 * (time.perf_counter() - t0)
    card_tree, cpu_tree = (state_to_numpy(resumed.state),
                           state_to_numpy(cpu_state))
    del cpu_state
    for name, val in card_tree.items():
        leaves = val.items() if isinstance(val, dict) else [(None, val)]
        for k, x in leaves:
            y = cpu_tree[name][k] if k is not None else cpu_tree[name]
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"[net] CPU load differs in {name}/{k}")
    del card_tree, cpu_tree
    _run_steps(world, NET_RESUME)
    _run_steps(resumed, NET_RESUME)
    for f in TRANSFORMS:
        if not torch.equal(getattr(world.state, f), getattr(resumed.state,
                                                            f)):
            d = (getattr(world.state, f) - getattr(resumed.state, f)).abs()
            raise AssertionError(f"[net] resumed {f} differs after "
                                 f"{NET_RESUME} steps (max {float(d.max())})")
    if not torch.equal(world.state.contacts.key, resumed.state.contacts.key):
        raise AssertionError("[net] resumed contact keys differ")
    del resumed
    out["checkpoint"] = dict(mb=len(blob) / 2**20, save_ms=save_ms,
                             load_ms=load_ms, cpu_load_ms=cpu_load_ms,
                             steps_equal=NET_RESUME)
    log(f"[net] checkpoint {len(blob) / 2**20:.3f} MB, save {save_ms:.1f} "
        f"ms, load on the card {load_ms:.1f} ms (CPU {cpu_load_ms:.1f} ms); "
        f"resumed world bit-equal to the live one after {NET_RESUME} steps "
        f"(max_pairs {world.meta.max_pairs})")
    del blob

    # 11b. a server and two clients over bytes
    t0 = time.perf_counter()
    spec_world = _emptied(pile_world()[0])
    play_world = _emptied(pile_world(et.Settings(pool_convex_rows=True))[0])
    build_s = time.perf_counter() - t0
    server = NetworkServer(world)
    down_a, up_a = NetChannel(NET_LOSS, 1), NetChannel(NET_LOSS, 2)
    down_b = NetChannel(NET_LOSS, 3, NET_DELAY)
    up_b = NetChannel(NET_LOSS, 4, NET_DELAY)
    server.register_client(1, down_a.send)
    server.register_client(2, down_b.send,
                           interest_half_extents=(PLAYER_HALF,) * 3)
    spectator = NetworkClient(spec_world, up_a.send,
                              enable_extrapolation=False)
    player = NetworkClient(play_world, up_b.send, enable_extrapolation=True,
                           background_extrapolation=True)
    # host read: the pile's top
    top = float(world.state.pos[world.state.is_dynamic][:, 1].max())
    ball = player.create_entity(et.RigidBodyDef(
        mass=1.0, shape=et.SphereShape(0.3), position=(0.0, top + 2.0, 0.0),
        material=et.Material(friction=0.5)))
    steer = {}
    step_s, update_s, sent_at = [], [], {}
    dt = world.settings.fixed_dt
    chans = (down_a, up_a, down_b, up_b)
    t_loop = time.perf_counter()
    for f in range(NET_FRAMES):
        now = (f + 1) * dt
        for c in chans:
            c.frame = f
        steer[f] = np.float32(0.1 + 0.9 * ((f * 37) % 100) / 100)
        player.record_input(now, "steer", [ball], np.array([steer[f]]))
        spectator.update(now)
        player.update(now)
        up_a.drain(lambda p, t: server.receive(1, p, t), now)
        up_b.drain(lambda p, t: server.receive(2, p, t), now)
        srv = server.clients[2]
        if srv.interest.follow is None and srv.entity_map.has_remote(ball):
            srv.interest.follow = srv.entity_map.to_local(ball)
        _sync()
        t0 = time.perf_counter()
        world.step(1)
        _sync()
        t1 = time.perf_counter()
        server.update(now)
        _sync()
        update_s.append(time.perf_counter() - t1)
        step_s.append(t1 - t0)
        # the server's transforms at every frame it sent a transient
        # snapshot (what the spectator then holds)
        if server.clients[1].last_snapshot_time == now:
            sent_at[f] = (world.state.pos.clone(), world.state.orn.clone())
        down_a.drain(spectator.receive, now)
        down_b.drain(player.receive, now)
        play_world.step(1)
    _sync()
    loop_s = time.perf_counter() - t_loop
    worker = player._extrap_worker
    if worker is None or not worker.alive or worker.error is not None:
        raise AssertionError(f"[net] the extrapolation worker died: "
                             f"{None if worker is None else worker.error!r}")
    replays, timeouts, replay_steps = (worker.replays, worker.timeouts,
                                       worker.steps)
    player.close()
    if worker.error is not None:
        raise worker.error
    # the spectator: every entity of its interest set mapped, the last
    # delivered transient snapshot's transforms equal to the server's
    interest = server.clients[1].interest.current
    mapped = set(spectator.entity_map.rem2loc)
    if mapped != interest:
        raise AssertionError(f"[net] the spectator maps {len(mapped)} "
                             f"entities of {len(interest)} in its interest")
    frame, snap_pkt = down_a.last["TransientSnapshot"]
    srv_pos, srv_orn = sent_at[frame]
    ents = torch.as_tensor(np.asarray(snap_pkt.snapshot.entities,
                                      np.int64), device=dev)
    locs = torch.as_tensor([spectator.entity_map.to_local(int(e))
                            for e in snap_pkt.snapshot.entities],
                           dtype=torch.long, device=dev)
    if not (torch.equal(spec_world.state.pos[locs], srv_pos[ents])
            and torch.equal(spec_world.state.orn[locs], srv_orn[ents])):
        raise AssertionError("[net] the spectator's transforms differ from "
                             f"the server's at frame {frame}")
    # the player's sphere on the server, steered by a recorded input
    srv_ball = server.clients[2].entity_map.to_local(ball)
    got = float(world.state.user["steer"][srv_ball])
    if not (bool(world.state.valid[srv_ball])
            and got in set(map(float, steer.values()))):
        raise AssertionError(f"[net] the player's steer on the server is "
                             f"{got}")
    for w, label in ((world, "net server"), (spec_world, "net spectator"),
                     (play_world, "net player")):
        _check_world(w, label)
    secs = NET_FRAMES * dt
    inst = down_a.handle_s.get("EntityEntered", 0.0)
    out["server"] = dict(
        frames=NET_FRAMES, step_ms=1e3 * statistics.mean(step_s),
        update_ms=1e3 * statistics.mean(update_s),
        update_ms_max=1e3 * max(update_s),
        frame_ms=1e3 * (statistics.mean(step_s) + statistics.mean(update_s)),
        loop_s=loop_s, client_worlds_build_s=build_s,
        bytes_per_s={"spectator": down_a.sent_bytes / secs,
                     "player": down_b.sent_bytes / secs},
        upload_bytes_per_s={"spectator": up_a.sent_bytes / secs,
                            "player": up_b.sent_bytes / secs},
        decoded=sum(c.decoded for c in chans),
        spectator_mapped=len(mapped), spectator_instantiate_s=inst,
        player_mapped=len(player.entity_map),
        equal_at_frame=frame, equal_entities=len(ents),
        replays=replays, replay_timeouts=timeouts,
        replay_steps=replay_steps, steer_on_server=got,
        varint_encoder=varint_encoder())
    log(f"[net] {NET_FRAMES} frames in {loop_s:.2f} s: server "
        f"{out['server']['frame_ms']:.2f} ms/frame (step "
        f"{out['server']['step_ms']:.2f}, update() "
        f"{out['server']['update_ms']:.2f}, max {1e3 * max(update_s):.2f});"
        f" to the spectator {down_a.sent_bytes / secs / 1e6:.3f} MB/s, to "
        f"the player {down_b.sent_bytes / secs / 1e6:.3f} MB/s; spectator "
        f"maps {len(mapped)} entities, instantiated in {inst:.3f} s, equal "
        f"to the server's bit for bit on {len(ents)} at frame {frame}; "
        f"player maps {len(player.entity_map)}; replays {replays} "
        f"({timeouts} timed out, {replay_steps} steps); steer {got}; "
        f"{sum(c.decoded for c in chans)} packets decoded; varint encoder "
        f"{varint_encoder()}; client worlds built in {build_s:.2f} s")
    del spec_world, play_world, spectator, player, server

    # 11c. the async worker on the same world
    streams = set()
    main_stream = torch.cuda.current_stream(dev).cuda_stream
    sim = AsyncSimulation(world, pre_step_callback=lambda w: streams.add(
        torch.cuda.current_stream(dev).cuda_stream))
    st = world.state
    # host read: the bodies to push and the ray grid over the pile
    pos = st.pos.cpu().numpy()
    dyn = np.nonzero(st.is_dynamic.cpu().numpy())[0]
    rng = np.random.default_rng(11)
    push = rng.choice(dyn, ASYNC_IMPULSES, replace=False)
    lo, hi = pos[dyn][:, [0, 2]].min(0), pos[dyn][:, [0, 2]].max(0)
    top = float(pos[dyn][:, 1].max())
    gx = np.linspace(lo[0], hi[0], N_RAYS_SIDE)
    gz = np.linspace(lo[1], hi[1], N_RAYS_SIDE)
    answers = []
    sim.start()
    t0 = time.perf_counter()
    for k, e in enumerate(push):
        sim.apply_impulse(int(e), (0.0, 0.5 + 0.01 * k, 0.0))
    for x in gx:
        for z in gz:
            sim.raycast_async((x, top + 1.0, z), (x, -1.0, z),
                              answers.append)
    time.sleep(max(0.0, ASYNC_SECONDS - (time.perf_counter() - t0)))
    alive, steps_done = sim.alive, sim.steps_done
    elapsed = time.perf_counter() - t0
    sim.stop()
    if sim.error is not None:
        raise sim.error
    if not (alive and steps_done > 0):
        raise AssertionError(f"[net] async worker alive {alive}, "
                             f"{steps_done} steps")
    if len(answers) != N_RAYS_SIDE ** 2:
        raise AssertionError(f"[net] {len(answers)} of {N_RAYS_SIDE ** 2} "
                             "raycasts answered")
    if streams != {main_stream}:
        raise AssertionError(f"[net] the worker stepped on streams "
                             f"{streams}, the main thread uses {main_stream}")
    _check_world(world, "net async")
    hits = sum(a["entity"] >= 0 for a in answers)
    out["async"] = dict(seconds=elapsed, steps=steps_done,
                        steps_per_s=steps_done / elapsed, target_hz=60.0,
                        impulses=ASYNC_IMPULSES, rays=len(answers),
                        ray_hits=hits, raycast_batches=sim.raycast_batches)
    log(f"[net] async worker: {steps_done} steps in {elapsed:.2f} s = "
        f"{steps_done / elapsed:.3f} steps/s (target 60); "
        f"{ASYNC_IMPULSES} impulses; {len(answers)} rays answered in "
        f"{sim.raycast_batches} batches, {hits} hits; one stream")

    # 11d. presentation at 30 fps over 60 Hz steps
    pres = Presentation(world)
    t_start = float(world.state.sim_time)
    calls = []
    for k in range(PRES_FRAMES):
        render = t_start + k / 30.0
        while float(world.state.sim_time) + dt <= render:
            world.step(1)
            pres.on_step()
        pres.observe(render)
        _sync()
        t0 = time.perf_counter()
        p, q = pres.transforms(render)
        calls.append(time.perf_counter() - t0)
        if not (np.isfinite(p).all() and np.isfinite(q).all()):
            raise AssertionError(f"[net] presentation frame {k} not finite")
    _check_world(world, "net presentation")
    launches = _read_counts()
    out["presentation"] = dict(
        frames=PRES_FRAMES, transforms_ms=1e3 * statistics.mean(calls),
        transforms_ms_max=1e3 * max(calls),
        delay_s=pres.presentation_delay)
    log(f"[net] presentation: {PRES_FRAMES} frames, transforms() "
        f"{1e3 * statistics.mean(calls):.3f} ms a call (max "
        f"{1e3 * max(calls):.3f}) at {world.state.capacity} bodies; "
        f"launches over the phase {launches}")
    for name in ("solve_iteration_fused", "ngs_iteration_fused",
                 "restitution_iteration_fused", "segment_sum",
                 "relvel_fused", "unified_features", "pair_order",
                 "collide_support"):
        if not launches[name]:
            raise AssertionError(f"[net] {name} never launched")
    no_unfused(launches, "net")
    if launches["count_overlaps"]:
        raise AssertionError("[net] K5 launched on the step")
    out["launches"] = launches
    return out, launches


# Phase 12: the float64 mode and the sweep broadphase.
SWEEP_STEPS = 60        # steps of the landed 10k pile under each broadphase
SWEEP_CALLS = 10        # broadphase calls timed on one state
N_SWEEP_BIG = 65_531    # mixed_pile bodies: 65,536 slots, the key limit
SWEEP_BIG_STEPS = 30    # the drop at 65,536 slots under "sweep"


class default_dtype:
    """PyTorch's default dtype set for a block (the port's f64 switch),
    restored after it."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __enter__(self):
        import torch
        self.old = torch.get_default_dtype()
        torch.set_default_dtype(self.dtype)

    def __exit__(self, *exc):
        import torch
        torch.set_default_dtype(self.old)


def _leaves(x, name="state"):
    """(path, tensor) of every tensor of a state."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        yield name, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{name}[{k}]")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{name}.{f.name}")


def _read_counts_f64() -> dict:
    from edyn_tpu_torch.collision.kernels import merge_kernel as mk
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    from edyn_tpu_torch.ops import overlap_count as ov
    return dict(sk.LAUNCHES_F64, **uk.LAUNCHES_F64, **ov.LAUNCHES_F64,
                **mk.LAUNCHES_F64)


def check_dtypes(st, label: str):
    """Every float leaf float64; the counters int32 and zero."""
    import torch
    bad = [n for n, t in _leaves(st)
           if t.is_floating_point() and t.dtype != torch.float64]
    if bad:
        raise AssertionError(f"[{label}] leaves not float64: {bad[:8]}")
    for n in ("overflow", "step_count", "island_stable_steps"):
        if getattr(st, n).dtype != torch.int32:
            raise AssertionError(f"[{label}] {n} is "
                                 f"{getattr(st, n).dtype}, int32 expected")
    if bool((st.overflow != 0).any()):
        raise AssertionError(f"[{label}] overflow counters "
                             f"{st.overflow.tolist()}")


def f64_path(n_bodies: int, steps: int, dev, f32_main: dict):
    """12a: phase 3's main path under the float64 default dtype, then
    ``suggest_max_pairs`` once; every launch count set to 0 before and read
    after: K1-K5's double entries launched (K5 once), the float entries
    not at all. Returns (world, f64 launches, summary)."""
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.ops import overlap_count as ov
    from edyn_tpu_torch.utils.scenes import mixed_pile
    with default_dtype(torch.float64):
        t0 = time.perf_counter()
        builder, _ = mixed_pile(n_bodies=n_bodies, seed=0)
        world = et.make_world(builder, et.Settings(), device=dev)
        torch.cuda.synchronize()
        check_dtypes(world.state, "f64 built")
        log(f"[f64] built {n_bodies} bodies in "
            f"{time.perf_counter() - t0:.2f} s")
        _reset_counts()
        t0 = time.perf_counter()
        first = max(1, steps - 20)
        with MergeWatch("10k pile f64") as watch:
            world.step_n(first)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            world.step_n(steps - first)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        budget = ov.suggest_max_pairs(world.state)
        f32c, f64c = _read_counts(), _read_counts_f64()
    st = world.state
    check_dtypes(st, "f64 stepped")
    if any(f32c.values()):
        raise AssertionError(f"[f64] float entries launched: {f32c}")
    per_step = max_launches_per_step(world.settings)
    for name, n in f64c.items():
        most = 1 if name == "count_overlaps" else per_step[name] * steps
        if not (0 < n <= most if most else n == 0):
            raise AssertionError(f"[f64] {name}_f64: {n} launches, expected "
                                 f"{f'1..{most}' if most else 0}")
    if f64c["merge"] != steps:
        raise AssertionError(f"[f64] merge_f64: {f64c['merge']} launches in "
                             f"{steps} steps, one a step expected")
    plain = ov.count_overlaps_plain(st.aabb_min, st.aabb_max, st.valid)
    if budget != max(256, int(plain * 1.5)):
        raise AssertionError(f"[f64] suggest_max_pairs gives {budget}, the "
                             f"plain count {plain}")
    lowest = check_pile(st, -FLOOR_BURIAL, "f64")
    out = dict(steps=steps, seconds=t2 - t0, steps_per_s=steps / (t2 - t0),
               ms_per_step=1e3 * (t2 - t0) / steps,
               last_steps_per_s=(steps - first) / (t2 - t1),
               f32_steps_per_s=f32_main["steps_per_s"],
               f32_ms_per_step=1e3 * f32_main["seconds"] / f32_main["steps"],
               max_pairs=world.meta.max_pairs, suggest_max_pairs=budget,
               lowest_centre=lowest,
               merge=watched_merges(watch, "10k pile f64"))
    out["f64_over_f32"] = out["steps_per_s"] / out["f32_steps_per_s"]
    log(f"[f64] {steps} steps in {t2 - t0:.3f} s = "
        f"{out['steps_per_s']:.3f} steps/s ({out['ms_per_step']:.2f} "
        f"ms/step); phase 3 at float32 in this call: "
        f"{out['f32_steps_per_s']:.3f} steps/s ({out['f32_ms_per_step']:.2f}"
        f" ms/step); ratio {out['f64_over_f32']:.3f}; launches of the double "
        f"entries {f64c}, of the float entries none; suggest_max_pairs "
        f"{budget}")
    return world, f64c, out


def f64_kernels(world, dev) -> dict:
    """12b: the double entries against their plain float64 versions on the
    card: K1-K3b on phase 2's random inputs at f64 and on a real step of
    12a's pile (max abs error 0), K4 on random pairs and on that step's
    live pairs (equal on every pair, pre-pass and order equal), K5 on
    random boxes, on its edge cases and on the pile (counts equal). Timed
    L2-cold, bounds at float64."""
    import torch
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    from edyn_tpu_torch.dynamics.solver_kernels import C_BASE, C_SR
    from edyn_tpu_torch.shapes.params import ShapeType
    f64 = lambda inp: {k: v.double() if v.is_floating_point() else v
                       for k, v in inp.items()}
    Rp_full = -(-16 * (N_BODIES + 5) // 128) * 128
    inp = f64(random_inputs(C_BASE + C_SR, Rp_full, N_BODIES + 5, 0, dev))
    out = dict(random=check_kernels(inp, True, "f64 random", exact=True),
               fused_random=check_fused(inp, True, "f64 random",
                                        stress=True))
    del inp
    check_kernels(f64(random_inputs(C_BASE, Rp_full, N_BODIES + 5, 1, dev)),
                  False, "f64 random, no spin/roll rows", exact=True)
    inp, with_sr = real_inputs(world)
    if inp["tbl"].dtype != torch.float64:
        raise AssertionError("the f64 pile's row table is not float64")
    out["real"] = check_kernels(inp, with_sr, "f64 real step", exact=True)
    out["fused_real"] = check_fused(inp, with_sr, "f64 real step")
    del inp
    st = world.state
    tbl, dims = uk.pack_side_table_t(st)
    rim = ShapeType.CYLINDER in world.meta.types_present
    ra, rb = random_pairs(st.capacity, K4_PAIRS, 2, dev)
    out["k4_random"] = [check_unified(tbl, ra, rb, dims, r,
                                      "f64 random pairs", False)
                        for r in (True, False)]
    ka, kb = unified_pairs(st)
    out["k4_real"] = check_unified(tbl, ka, kb, dims, rim, "f64 real step",
                                   True)
    out["C"] = tbl.shape[0]
    amin, amax, v = random_aabbs(65_573, 3, dev)
    out["k5_random"] = check_overlaps(amin.double(), amax.double(), v,
                                      "f64 random AABBs", True)
    out["k5_edges"] = k5_edge_cases(dev, torch.float64)
    out["k5_real"] = check_overlaps(st.aabb_min.contiguous(),
                                    st.aabb_max.contiguous(), st.valid,
                                    "f64 real step", False)
    return out


def f64_card_vs_cpu(dev) -> dict:
    """12c: phase 5 under the float64 default dtype (its settled 1,000-body
    pile, one step on the card and on the CPU, under phase 5's rule), and
    the manifolds with another point set."""
    import torch
    with default_dtype(torch.float64):
        out, w = card_vs_cpu(dev, label="card-vs-cpu f64")
    check_dtypes(w.state, "card-vs-cpu f64")
    return out


def _pair_keys(st, meta):
    """The sorted pair list a step of ``st`` used (the manifold table's
    sorted view)."""
    return st.contacts.sort_key[:meta.max_pairs]


def sweep_window_for(st, meta, window: int) -> tuple:
    """The smallest of window, 2 window, 4 window, ... at which
    ``find_pairs_sweep`` raises no window alarm on ``st``; and the alarms
    and pairs missed against ``find_pairs`` at ``window`` itself."""
    import torch
    from edyn_tpu_torch.collision.broadphase import (INVALID_KEY,
                                                     find_pairs,
                                                     find_pairs_sweep)
    dense = find_pairs(st, meta.max_pairs, meta.wide_cap)[0]
    first = find_pairs_sweep(st, meta.max_pairs, window, meta.wide_cap)
    missed = int((~torch.isin(dense[dense != INVALID_KEY], first[0])).sum())
    W, alarms = window, first[5]
    while alarms and W < st.capacity:
        W *= 2
        alarms = find_pairs_sweep(st, meta.max_pairs, W, meta.wide_cap)[5]
    return W, first[5], missed


def sweep_path(landed, dev) -> dict:
    """12d: from the landed 10k pile (float32), 60 steps under
    ``broadphase_mode="sweep"`` and under ``"dense"`` from the same state:
    the sorted pair keys equal at every step (then every state equal), at
    the narrowest window of 192 x 2^k that raises no alarm on the landed
    state (the default window's alarms and the pairs it misses there are
    printed: a landed pile overlaps along every axis over more than 192
    bodies); the broadphase alone timed, ``find_pairs`` against
    ``find_pairs_sweep`` at both windows, ``SWEEP_CALLS`` calls each. Then
    a 30-step drop of ``mixed_pile(65_531)`` (65,536 slots, the key limit)
    under "sweep" after one dense step that seats the boxes, at the window
    chosen as on the landed pile, each step's pair keys equal to
    ``find_pairs`` on the same admission boxes, and the two broadphases
    timed there."""
    import dataclasses
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.collision.broadphase import (find_pairs,
                                                     find_pairs_sweep)
    from edyn_tpu_torch.core.convert import state_from_numpy
    from edyn_tpu_torch.utils.scenes import mixed_pile
    tree, meta, settings = landed
    st0 = state_from_numpy(tree, dev)
    W, alarms0, missed0 = sweep_window_for(st0, meta, meta.sweep_window)
    log(f"[sweep] landed pile: window {meta.sweep_window} raises {alarms0} "
        f"alarms and misses {missed0} of the dense path's pairs; window {W} "
        f"raises none")
    worlds = {}
    for mode in ("dense", "sweep"):
        worlds[mode] = et.World(
            state_from_numpy(tree, dev), settings,
            dataclasses.replace(meta, broadphase_mode=mode, sweep_window=W))
    alarms = 0
    for i in range(SWEEP_STEPS):
        for w in worlds.values():
            w.step()
        kd = _pair_keys(worlds["dense"].state, worlds["dense"].meta)
        ks = _pair_keys(worlds["sweep"].state, worlds["sweep"].meta)
        alarms += int(worlds["sweep"].state.overflow[3])
        if not torch.equal(kd, ks):
            raise AssertionError(f"[sweep] step {i}: sweep and dense pair "
                                 f"keys differ (window {W}, alarms so far "
                                 f"{alarms})")
    for f in ("pos", "orn", "linvel", "angvel"):
        if not torch.equal(getattr(worlds["dense"].state, f),
                           getattr(worlds["sweep"].state, f)):
            raise AssertionError(f"[sweep] the two worlds' {f} differ")
    st, m = worlds["sweep"].state, worlds["sweep"].meta

    def timed(fn, calls=SWEEP_CALLS):
        fn()
        torch.cuda.synchronize()
        t = []
        for _ in range(calls):
            s, e = _events()
            s.record()
            fn()
            e.record()
            e.synchronize()
            t.append(s.elapsed_time(e))
        return statistics.median(t)

    dense_ms = timed(lambda: find_pairs(st, m.max_pairs, m.wide_cap))
    sweep_ms = timed(lambda: find_pairs_sweep(st, m.max_pairs, W,
                                              m.wide_cap))
    sweep192_ms = timed(lambda: find_pairs_sweep(
        st, m.max_pairs, meta.sweep_window, m.wide_cap))
    out = dict(steps=SWEEP_STEPS, bodies=st.capacity, max_pairs=m.max_pairs,
               window=W, alarms=alarms, default_window=meta.sweep_window,
               default_window_alarms=alarms0,
               default_window_missed_pairs=missed0, dense_ms=dense_ms,
               sweep_ms=sweep_ms, sweep_default_window_ms=sweep192_ms)
    log(f"[sweep] {st.capacity} slots: {SWEEP_STEPS} steps under sweep "
        f"(window {W}) and dense, pair keys equal at every step, states "
        f"equal; window alarms {alarms}; broadphase alone (median of "
        f"{SWEEP_CALLS} calls, max_pairs {m.max_pairs}): dense "
        f"{dense_ms:.2f} ms, sweep {sweep_ms:.2f} ms at window {W}, "
        f"{sweep192_ms:.2f} ms at window {meta.sweep_window}")
    del worlds, st, st0

    # the key limit: 65,536 slots, a drop under "sweep". The first step
    # (dense) seats the admission boxes; the window is then chosen as on
    # the landed pile: the grid's slabs of 41 x 41 bodies share their
    # minimum on every axis, so 192 bodies do not reach the next slab.
    t0 = time.perf_counter()
    builder, _ = mixed_pile(n_bodies=N_SWEEP_BIG, seed=0)
    w = et.make_world(builder, et.Settings(), device=dev)
    w.meta = dataclasses.replace(w.meta, broadphase_mode="dense")
    w.step()
    W, alarms0, missed0 = sweep_window_for(w.state, w.meta,
                                           meta.sweep_window)
    w.meta = dataclasses.replace(w.meta, broadphase_mode="sweep",
                                 sweep_window=W)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    log(f"[sweep 65k] {w.state.capacity} slots seated: window "
        f"{meta.sweep_window} raises {alarms0} alarms and misses {missed0} "
        f"of the dense path's pairs; window {W} raises none")
    alarms, checked = 0, 0
    step_s = 0.0
    for i in range(SWEEP_BIG_STEPS):
        P0 = w.meta.max_pairs
        ts = time.perf_counter()
        w.step()
        torch.cuda.synchronize()
        step_s += time.perf_counter() - ts
        alarms += int(w.state.overflow[3])
        # a step that dropped pairs grew the world (its list is the
        # truncated one, cut in each broadphase's own order): not compared
        if w.meta.max_pairs == P0:
            keys = find_pairs(w.state, P0, w.meta.wide_cap)[0]
            if not torch.equal(keys, _pair_keys(w.state, w.meta)):
                raise AssertionError(f"[sweep 65k] step {i}: the sweep's "
                                     f"keys differ from find_pairs' (window "
                                     f"{W}, alarms so far {alarms})")
            checked += 1
    st, m = w.state, w.meta
    for f in ("pos", "orn", "linvel", "angvel"):
        if not bool(torch.isfinite(getattr(st, f)).all()):
            raise AssertionError(f"[sweep 65k] state.{f} is not finite")
    big_dense = timed(lambda: find_pairs(st, m.max_pairs, m.wide_cap), 3)
    big_sweep = timed(lambda: find_pairs_sweep(st, m.max_pairs, W,
                                               m.wide_cap))
    big_sweep192 = timed(lambda: find_pairs_sweep(
        st, m.max_pairs, meta.sweep_window, m.wide_cap))
    out["big"] = dict(bodies=st.capacity, steps=SWEEP_BIG_STEPS,
                      steps_checked=checked, window=W, alarms=alarms,
                      default_window_alarms=alarms0,
                      default_window_missed_pairs=missed0,
                      max_pairs=m.max_pairs, build_s=t1 - t0,
                      ms_per_step=1e3 * step_s / SWEEP_BIG_STEPS,
                      seconds=time.perf_counter() - t0,
                      dense_ms=big_dense, sweep_ms=big_sweep,
                      sweep_default_window_ms=big_sweep192,
                      overflow=w.overflow_counters())
    log(f"[sweep 65k] {st.capacity} slots, {SWEEP_BIG_STEPS}-step drop "
        f"under sweep at window {W} ({1e3 * step_s / SWEEP_BIG_STEPS:.1f} "
        f"ms/step; build and the seating step {t1 - t0:.1f} s, part "
        f"{out['big']['seconds']:.1f} s): keys equal to find_pairs' at "
        f"{checked} of {SWEEP_BIG_STEPS} steps (the others dropped pairs and "
        f"grew), window alarms {alarms}, max_pairs {m.max_pairs}; "
        f"broadphase alone: dense {big_dense:.2f} ms (median of 3), sweep "
        f"{big_sweep:.2f} ms at window {W}, {big_sweep192:.2f} ms at window "
        f"{meta.sweep_window}")
    return out


def f64_kernel_entries(kernels12, launches) -> list:
    """The kernels line's entries of the five double builds."""
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    rand, real = kernels12["random"], kernels12["real"]
    k4 = kernels12["k4_real"]
    k4_all = kernels12["k4_random"] + [k4]
    k5_all = ([kernels12["k5_random"], kernels12["k5_real"]]
              + list(kernels12["k5_edges"].values()))
    out = [fused_entry(name, kernels12["fused_real"][name],
                       {"random": kernels12["fused_random"][name]},
                       {"launches": launches[name]}, "double",
                       {"random": rand, "real": real})
           for name in FUSED]
    for name in ("relvel",):
        r = rand[name]
        out.append(dict(
            name=f"{name}_f64", route="cuda", source=SOURCE,
            replaces=KERNELS[name][0], dtype="float64",
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"], real[name]["max_abs_err"]),
            tol="0", ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            warm_ms=r["warm_ms"], call_ms=r["call_ms"], C=r["C"], Rp=r["Rp"],
            real_Rp=real[name]["Rp"], real_ms=real[name]["ms"],
            real_plain_ms=real[name]["plain_ms"],
            real_bound_ms=real[name]["bound_ms"],
            **build_info("solver_kernels", SOLVER_KERNELS[name], "double")))
    out.append(dict(
        K4, name="collide_support_f64", route="cuda", dtype="float64",
        launches=launches["collide_support"],
        pre_pass_launches=launches["unified_features"],
        pair_order_launches=launches["pair_order"],
        max_abs_err=max(r["max_abs_err"] for r in k4_all),
        tol="equal to the plain version on every pair",
        bit_equal_pairs=sum(r["bit_equal_pairs"] for r in k4_all),
        pairs=sum(r["pairs"] for r in k4_all), ms=k4["ms"],
        plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
        bound_by=k4["bound_by"], library_ms=None, main_ms=k4["main_ms"],
        features_ms=k4["features_ms"], order_ms=k4["order_ms"],
        real_pairs=k4["pairs"], classes=k4["classes"],
        ops_per_pair=k4["ops_per_pair"], C=kernels12["C"],
        **build_info("unified_kernel", "unified_kernel", "double")))
    k5 = kernels12["k5_random"]
    out.append(dict(
        K5, name="count_overlaps_f64", route="cuda", dtype="float64",
        launches=launches["count_overlaps"],
        max_abs_err=max(r["max_abs_err"] for r in k5_all), tol="exact",
        ms=k5["ms"], plain_ms=k5["plain_ms"], bound_ms=k5["bound_ms"],
        bound_by=k5["bound_by"], library_ms=None, n=k5["n"],
        edge_cases={k: v["count"] for k, v in
                    kernels12["k5_edges"].items()},
        **build_info("overlap_count", "overlap_kernel", "double")))
    return out


def phase12(dev, main: dict, landed, versus=None) -> tuple:
    """Phase 12 in order: 12a, 12b, 12c, 12d; 12c's summary is ``versus``
    where it ran earlier (beside phase 5). Returns (summary, launches of
    the double entries on 12a's path, the kernels line's f64 entries)."""
    t0 = time.perf_counter()
    world, launches, f64 = f64_path(N_BODIES, STEPS, dev, main)
    kern = f64_kernels(world, dev)
    del world
    f64["card_vs_cpu"] = versus or f64_card_vs_cpu(dev)
    t1 = time.perf_counter()
    sweep = sweep_path(landed, dev)
    log(f"[phase 12] f64 parts {t1 - t0:.1f} s, sweep "
        f"{time.perf_counter() - t1:.1f} s")
    return (dict(f64=f64, f64_kernels=kern, sweep=sweep), launches,
            f64_kernel_entries(kern, launches))


SHARDS = 4              # phase 13a's shards
SHARD_STEPS = 120       # 13a: steps from the drop, as phase 3
# phase 3's pile grows its pair budget to 208,128 while it lands (PR 8's
# runs); 13a's runs start there, so that neither drops a pair
SHARD_MAX_PAIRS = 208_128
SHARD_KS = (1, 2, 4)    # 13c: shard counts timed on one card
SHARD_TIMED = 4         # 13c: steps timed at each k, twice, in turns
SHARD_PROFILED = 1      # 13c: steps under the profiler and the span timers
SHARD_LEAD = 25         # 13b: unsharded steps into the first contacts
SHARD_KERNELS = ("solve_iteration_fused", "ngs_iteration_fused",
                 "restitution_iteration_fused", "relvel_fused",
                 "unified_features",
                 "pair_order", "collide_support")


def shard_devices(k: int) -> list:
    """k shards over the host's cards, in turn (all on cuda:0 with one)."""
    import torch
    n = torch.cuda.device_count()
    return [torch.device("cuda", s % n) for s in range(k)]


def _differing(a, b) -> list:
    """Paths of the leaves of two states that are not torch.equal."""
    import torch
    return [n for (n, x), (_, y) in zip(_leaves(a), _leaves(b))
            if not torch.equal(x, y)]


def _sync_all():
    import torch
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def _first_difference(start, settings, meta, step, dev_state, steps: int):
    """Step the unsharded and the sharded step side by side from one
    state; (step, leaves) of the first that differ, or None."""
    from edyn_tpu_torch.simulation.stepper import physics_step
    st = start
    for i in range(1, steps + 1):
        st = physics_step(st, settings, meta)
        dev_state = step(dev_state)
        bad = _differing(dev_state, st)
        if bad:
            return i, bad
    return None


def _shard_counts(mesh) -> list:
    """Each shard's launches per kernel step (cuda_lib.DEVICE_LAUNCHES)."""
    from edyn_tpu_torch.utils import cuda_lib
    return [dict(cuda_lib.DEVICE_LAUNCHES.get((str(d), s), {}))
            for s, d in enumerate(mesh.devices)]


def chain_hops(dev, n: int = N_BODIES + 5, rows: int = 160_128,
               k: int = SHARDS) -> dict:
    """The ordered chain with every part a hop (``merge=False``: the path
    of shards on separate cards), on one card: equal, bit for bit, to one
    ``index_sum`` over all rows, in both layouts."""
    import torch
    from edyn_tpu_torch.dynamics import solver
    from edyn_tpu_torch.dynamics.solver import chain_index_sum
    from edyn_tpu_torch.parallel.collectives import ranges
    g = torch.Generator(device="cpu").manual_seed(13)
    x = torch.randn(n, 6, generator=g).to(dev)
    idx = torch.randint(0, n, (rows,), generator=g).to(dev)
    src = (torch.randn(rows, 6, generator=g) * 10.0 ** torch.randint(
        -4, 4, (rows, 1), generator=g)).to(dev)
    src[::3] = 0.0   # zero rows take index_sum's scratch rows
    parts = [(idx[a:b], src[a:b]) for a, b in ranges(rows, k)]
    out = {}
    for merge in (False, True):
        got = chain_index_sum(x, parts, merge=merge)
        got_t = chain_index_sum(x.T.contiguous(), [(i, t.T) for i, t in parts],
                                dim=1, merge=merge)
        want = solver.index_sum(x, idx, src)
        out["hops" if not merge else "merged"] = bool(
            torch.equal(got, want) and torch.equal(got_t, want.T))
    if not all(out.values()):
        raise AssertionError(f"[sharded] the chain differs from index_sum: "
                             f"{out}")
    return out


def batch_products(dev) -> dict:
    """Phase 13a, a measurement (ROADMAP P14): whether the first 64 rows'
    3x3-matrix-by-3-vector ``einsum`` (a batched GEMM on the card, as the
    contact rows' ``solver._mv``) gives the same bits at R rows as alone,
    for R from 64 to SHARD_MAX_PAIRS. The step builds its rows once at the
    table's full width, so no shard's rows depend on it."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(9)
    n = SHARD_MAX_PAIRS
    m = torch.randn(n, 3, 3, generator=g).to(dev)
    x = torch.randn(n, 3, generator=g).to(dev)

    def mv(r):
        return torch.einsum("...ij,...j->...i", m[:r], x[:r])[:64]
    ref = mv(64)
    out = {r: bool(torch.equal(mv(r), ref))
           for r in (256, 1024, 4096, 20_000, 52_224, 160_080, n)}
    log(f"[sharded] einsum's first 64 rows equal to their own at R rows: "
        f"{out}")
    return out


def shard_k3b(state, settings, meta, mesh) -> list:
    """13a: the fused K3b held by ``hold_k3b`` on every shard's rows of a
    sharded step from ``state`` (the rows cut as the step cuts them, each
    shard's table and targets on its device). Returns whether each shard
    had an active row."""
    import dataclasses
    import torch
    from edyn_tpu_torch.dynamics import scatter, solver
    from edyn_tpu_torch.simulation import stepper
    meta = dataclasses.replace(meta, shard_mesh=mesh)
    st, _, rows, _ = stepper.prepare_rows(state, settings, meta)
    packs = []
    for s, r in enumerate(stepper._shard_rows(rows, meta, mesh)):
        with mesh.scope(s):
            packs.append(solver.ShardPack.of_rows(r))
    plan = scatter.ScatterPlan.build(packs, scatter.movable(st), mesh)
    vel = torch.cat([st.linvel, st.angvel], 1)
    active = []
    for s, p in enumerate(packs):
        with mesh.scope(s):
            active.append(hold_k3b(p.tbl, vel.to(p.device), plan.shards[s],
                                   plan, f"sharded, shard {s}"))
    return active


def sharded_pile(dev) -> tuple:
    """Phase 13a: phase 3's pile stepped sharded over SHARDS shards, held
    bit-equal to the unsharded step from the same start, twice: the second
    run with every shard's part of each body-space sum a hop of its own
    (``hop_each_shard``, the path of shards on distinct cards); each shard
    launching each kernel of the path; the fused K3b held on every shard
    (``shard_k3b``). Returns (summary, launches of the first sharded run,
    the end state, settings, meta)."""
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.parallel import make_mesh, make_sharded_step
    from edyn_tpu_torch.simulation.stepper import physics_step
    from edyn_tpu_torch.utils import cuda_lib
    from edyn_tpu_torch.utils.scenes import mixed_pile

    world = et.make_world(mixed_pile(n_bodies=N_BODIES, seed=0)[0],
                          et.Settings(), max_pairs=SHARD_MAX_PAIRS,
                          device=dev)
    start, settings, meta = world.state, world.settings, world.meta
    del world
    _sync_all()
    t0 = time.perf_counter()
    ref = start
    for _ in range(SHARD_STEPS):
        ref = physics_step(ref, settings, meta)
    _sync_all()
    t_ref = time.perf_counter() - t0
    if int(ref.overflow.abs().sum()):
        raise AssertionError(f"[sharded] the unsharded run dropped: "
                             f"{ref.overflow.tolist()}")

    runs = []
    watch = MergeWatch("10k pile sharded")
    for run, hops in enumerate((False, True)):
        mesh = make_mesh(shard_devices(SHARDS), hop_each_shard=hops)
        step, dev0 = make_sharded_step(mesh, start, settings, meta)
        _reset_counts()
        cuda_lib.reset_device_launches()
        _sync_all()
        t0 = time.perf_counter()
        ds = dev0
        with contextlib.nullcontext() if hops else watch:
            for _ in range(SHARD_STEPS):
                ds = step(ds)
        _sync_all()
        runs.append(dict(seconds=time.perf_counter() - t0,
                         launches=_read_counts(),
                         per_shard=_shard_counts(mesh), step=step,
                         start=dev0, state=ds, mesh=mesh))
        log(f"[sharded] run {run + 1}: {SHARD_STEPS} steps over {SHARDS} "
            f"shards on {[str(d) for d in mesh.devices]}, a hop per "
            f"{'shard' if hops else 'device'}, in "
            f"{runs[-1]['seconds']:.3f} s = "
            f"{SHARD_STEPS / runs[-1]['seconds']:.3f} steps/s (unsharded "
            f"{SHARD_STEPS / t_ref:.3f}); launches {runs[-1]['launches']}; "
            f"per shard {runs[-1]['per_shard']}")
    for r in runs:
        bad = _differing(r["state"], ref)
        if bad:
            where = _first_difference(start, settings, meta, r["step"],
                                      r["start"], SHARD_STEPS)
            raise AssertionError(f"[sharded] the sharded pile differs from "
                                 f"the unsharded one at {bad[:8]}; first at "
                                 f"(step, leaves) {where}")
    got = runs[0]["state"]
    launches = runs[0]["launches"]
    for r in runs:
        if r["launches"]["count_overlaps"]:
            raise AssertionError("[sharded] K5 launched on the step")
        if not r["launches"]["segment_sum"]:
            raise AssertionError("[sharded] segment_sum never launched")
        no_unfused(r["launches"], "sharded")
        for s, counts in enumerate(r["per_shard"]):
            missing = [k for k in SHARD_KERNELS if not counts.get(k)]
            if missing or counts.get("count_overlaps"):
                raise AssertionError(f"[sharded] shard {s} on "
                                     f"{mesh.devices[s]} launched no "
                                     f"{missing} (or K5): {counts}")
            if counts.get("merge") != SHARD_STEPS:
                raise AssertionError(f"[sharded] shard {s}: "
                                     f"{counts.get('merge')} merges in "
                                     f"{SHARD_STEPS} steps, one a step "
                                     f"expected")
    if int(got.overflow.abs().sum()):
        raise AssertionError(f"[sharded] overflow {got.overflow.tolist()}")
    lowest = check_pile(got, -FLOOR_BURIAL, "sharded")
    k3b_active = shard_k3b(got, settings, meta, runs[0]["mesh"])
    log(f"[sharded] relvel_fused on every shard of a step from the end "
        f"state: bit-equal to the unfused pass and to its plain version, "
        f"flags equal; rows active per shard {k3b_active}")
    chains = chain_hops(dev)
    log(f"[sharded] chain against index_sum, bit-equal: {chains}")
    summary = dict(chain_bit_equal=chains, batch_products=batch_products(dev),
        shards=SHARDS, devices=[str(d) for d in mesh.devices],
        steps=SHARD_STEPS, max_pairs=SHARD_MAX_PAIRS,
        bit_equal_to_unsharded=True, hop_per_shard_bit_equal=True,
        unsharded_steps_per_s=SHARD_STEPS / t_ref,
        sharded_steps_per_s=[SHARD_STEPS / r["seconds"] for r in runs],
        launches=launches, per_shard_launches=runs[0]["per_shard"],
        k3b_bit_equal_per_shard=True, k3b_active_per_shard=k3b_active,
        live_points=int(got.contacts.point_valid.sum()),
        lowest_centre=lowest, merge=watched_merges(watch))
    del ref, runs, watch
    return summary, launches, got, settings, meta


def _jax_case(name, dev):
    """A world of tests/test_sharding.py's case ``name`` on ``dev``, at
    that test's sizes, stepped unsharded into its first contacts (the
    asleep case: 40 steps, put to sleep, two bodies woken, 1 step)."""
    import dataclasses
    import edyn_tpu_torch as et
    from edyn_tpu_torch.utils.scenes import mixed_pile, rich_scene
    n_dev = 8

    def cap(b):
        return -(-len(b.defs) // n_dev) * n_dev
    if name == "pile":
        b, _ = mixed_pile(n_bodies=56)
        return et.make_world(b, capacity=cap(b), max_pairs=1024,
                             max_joints=n_dev, device=dev).step(SHARD_LEAD)
    if name == "rich_sweep":
        b, _ = rich_scene(n_bodies=48, n_chains=2, chain_links=4, mesh_n=8)
        w = et.make_world(b, capacity=cap(b), max_pairs=1024, device=dev)
        w.meta = dataclasses.replace(w.meta, broadphase_mode="sweep")
        return w.step(SHARD_LEAD)
    b, ids = mixed_pile(n_bodies=56)
    w = et.make_world(b, capacity=cap(b), max_pairs=4096, max_joints=n_dev,
                      device=dev)
    w.step(40)
    w.put_to_sleep()
    w.wake_set({ids[0], ids[1]})
    return w.step(1)


def jax_cases_on_card(dev) -> dict:
    """Phase 13b: the three cases of tests/test_sharding.py on the card,
    sharded over 8 shards, each held bit-equal to the unsharded step at
    every step (5 steps, as that test; the asleep case 3, its solve at the
    ladder's narrowest tier, the JAX formula with quantum 256 x 8)."""
    from edyn_tpu_torch.parallel import make_mesh, make_sharded_step
    from edyn_tpu_torch.simulation import stepper
    out = {}
    mesh = make_mesh(shard_devices(8))
    for name, steps in (("pile", 5), ("rich_sweep", 5), ("asleep", 3)):
        w = _jax_case(name, dev)
        st = w.state
        step, ds = make_sharded_step(mesh, st, w.settings, w.meta)
        widths = []
        real = stepper.solve_width

        def record(rows, meta):
            width = real(rows, meta)
            if meta.shard_mesh is not None:
                widths.append((rows.valid.shape[0], width))
            return width
        stepper.solve_width = record
        try:
            for i in range(1, steps + 1):
                ds = step(ds)
                st = stepper.physics_step(st, w.settings, w.meta)
                bad = _differing(ds, st)
                if bad:
                    raise AssertionError(f"[13b {name}] step {i} differs at "
                                         f"{bad[:8]}")
        finally:
            stepper.solve_width = real
        rec = dict(steps=steps, shards=8,
                   live_points=int(st.contacts.point_valid.sum()),
                   widths=sorted(set(widths)))
        if name == "asleep":
            r_full, width = widths[0]
            quantum = 256 * 8
            tier0 = max(quantum, -(-(r_full // 8) // quantum) * quantum)
            if not (tier0 < r_full and width == tier0):
                raise AssertionError(f"[13b asleep] width {width}, the "
                                     f"narrow tier {tier0} of {r_full}")
            rec["narrow_tier"] = tier0
        if not rec["live_points"]:
            raise AssertionError(f"[13b {name}] no contact points")
        log(f"[13b] {name}: {rec}")
        out[name] = rec
    return out


def shard_timing(landed, settings, meta) -> dict:
    """Phase 13c: the landed pile stepped unsharded and at each k of
    SHARD_KS on one card (and over every card where there are several),
    SHARD_TIMED steps each, in turns (unsharded, 1, 2, 4, 4, 2, 1,
    unsharded); then per k, SHARD_PROFILED steps with the step's spans
    recorded (``utils.profile``: the gathers, splits and chains on the
    device's clock), SHARD_PROFILED steps under the profiler (kernels a
    step, device busy), and the peak memory of each device over the timed
    steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from edyn_tpu_torch.parallel import make_mesh
    from edyn_tpu_torch.parallel import make_sharded_step
    from edyn_tpu_torch.utils import profile
    from edyn_tpu_torch.simulation.stepper import physics_step

    configs = [("unsharded", None)] + [
        (f"k={k}", make_mesh(shard_devices(k))) for k in SHARD_KS]
    n = torch.cuda.device_count()
    if n > 1:
        configs.append((f"{n} cards", make_mesh(
            [torch.device("cuda", i) for i in range(n)])))

    def runner(mesh):
        if mesh is None:
            def go(steps):
                st = landed
                for _ in range(steps):
                    st = physics_step(st, settings, meta)
            return go
        step, ds0 = make_sharded_step(mesh, landed, settings, meta)

        def go(steps):
            ds = ds0
            for _ in range(steps):
                ds = step(ds)
        return go

    runs = {name: runner(mesh) for name, mesh in configs}
    for go in runs.values():
        go(1)   # warm: first use of each width
    times = {name: [] for name in runs}
    order = list(runs) + list(reversed(list(runs)))
    peak = {}
    for name in order:
        for d in range(n):
            torch.cuda.reset_peak_memory_stats(d)
        _sync_all()
        t0 = time.perf_counter()
        runs[name](SHARD_TIMED)
        _sync_all()
        times[name].append(1e3 * (time.perf_counter() - t0) / SHARD_TIMED)
        peak[name] = [torch.cuda.max_memory_allocated(d) / 2**20
                      for d in range(n)]

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    out = {}
    for name in runs:
        profile.reset()
        _sync_all()
        t0 = time.perf_counter()
        with profile.enable():
            runs[name](SHARD_PROFILED)
        _sync_all()
        wall = time.perf_counter() - t0
        rec = profile.recorded()["spans"]
        spans = {k: rec.get(k, {}).get("device_ms", 0.0) * 1e-3
                 for k in ("gather", "split", "chain")}
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as pr:
            runs[name](SHARD_PROFILED)
            _sync_all()
        # the spans recorded under the profiler are annotations, not work
        names = set(profile.recorded()["spans"])
        kern = [(dev_us(e), e.count) for e in pr.key_averages()
                if e.device_type != DeviceType.CPU and dev_us(e) > 0
                and e.key not in names]
        ms = times[name]
        out[name] = dict(
            ms_per_step=ms, steps_per_s=[1e3 / m for m in ms],
            spans_ms_per_step={k: 1e3 * v / SHARD_PROFILED
                               for k, v in spans.items()},
            spans_share=sum(spans.values()) / wall,
            kernels_per_step=sum(c for _, c in kern) / SHARD_PROFILED,
            device_ms_per_step=sum(t for t, _ in kern) * 1e-3
            / SHARD_PROFILED,
            peak_mib_per_device=peak[name])
        log(f"[13c] {name}: {out[name]}")
    return out


def sharded_pile_call(dev, path: str) -> dict:
    """13a in a process of its own (``start_call``): ``sharded_pile``'s
    summary, its launches and its seconds, with its end state, settings and
    meta pickled to ``path`` for 13c."""
    import pickle
    from edyn_tpu_torch.core.convert import state_to_numpy
    t0 = time.perf_counter()
    summary, launches, got, settings, meta = sharded_pile(dev)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump((state_to_numpy(got), settings, meta), f)
    return dict(summary=summary, launches=launches,
                seconds=time.perf_counter() - t0)


def jax_cases_call(dev) -> dict:
    """13b in a process of its own (``start_call``), with its seconds."""
    t0 = time.perf_counter()
    out = jax_cases_on_card(dev)
    return dict(cases=out, seconds=time.perf_counter() - t0)


def landed_shards(a: dict, path: str, dev) -> tuple:
    """``sharded_pile_call``'s result and its pickled end state, on
    ``dev``: (13a's summary, its launches, the state, settings, meta)."""
    import pickle
    from edyn_tpu_torch.core.convert import state_from_numpy
    with open(path, "rb") as f:
        tree, settings, meta = pickle.load(f)
    os.remove(path)
    return (a["summary"], a["launches"], state_from_numpy(tree, dev),
            settings, meta)


SHARD_STATE = os.path.join(ROOT, "build", "chip_smoke_13a.pkl")


def phase13(dev, a=None, b=None) -> tuple:
    """Phase 13: 13a and 13b (``sharded_pile_call``'s and
    ``jax_cases_call``'s results where they ran earlier, in processes of
    their own; else here), then 13c on 13a's end state. Returns (summary,
    launches of 13a's sharded run)."""
    a = a or sharded_pile_call(dev, SHARD_STATE)
    b = b or jax_cases_call(dev)
    a13, launches, landed, settings, meta = landed_shards(a, SHARD_STATE,
                                                          dev)
    t0 = time.perf_counter()
    c = shard_timing(landed, settings, meta)
    del landed
    log(f"[phase 13] 13a {a['seconds']:.1f} s, 13b {b['seconds']:.1f} s, "
        f"13c {time.perf_counter() - t0:.1f} s; gpu: {gpu_line()}")
    return dict(sharded_pile=a13, jax_cases=b["cases"], timing=c), launches


# ---------------------------------------------------------------------------
# phase 14: the manifold merge kernel
# ---------------------------------------------------------------------------

MERGE_HELD_EVERY = 30         # a watched run's calls between held merges
MERGE_65K_STEPS = 120         # into the landing (1.8M pairs at 120)
MERGE_65K_CONFIG = os.path.join(ROOT, "portbench", "configs", "pile65k.json")
# the orders PyTorch adds in on the card, which the kernel repeats
MERGE_ORDERS = ("sum3_x0_x2_x1", "norm4_x02_x13")


def merge_slot_bytes(itemsize: int) -> int:
    """Bytes one slot of the merge moves: its pair's two ids and two flags,
    its four carried points read and four written (a validity byte, the
    attachment and lifetime int32s and 18 scalars each: pivots, normal,
    distance, six impulses, two scales) and its four fresh points (14
    scalars each). The two bodies gathered by index are L2 hits, not
    counted."""
    point = 1 + 4 + 4 + 18 * itemsize
    return 4 + 4 + 1 + 1 + 2 * 4 * point + 4 * 14 * itemsize


def sum_orders(dev) -> dict:
    """How PyTorch adds on the card, which the merge kernel repeats: the
    share of rows where torch.sum over a last dimension of 3 equals
    (x0 + x2) + x1 (the kernel's order) and (x0 + x1) + x2, and where
    torch.linalg.vector_norm over 4 equals sqrt((a^2 + c^2) + (b^2 + d^2))
    (the kernel's order) and sqrt((a^2 + b^2) + (c^2 + d^2)). Raises
    unless the kernel's orders (``MERGE_ORDERS``) hold on every row."""
    import torch
    out = {}
    g = torch.Generator(device=dev).manual_seed(0)
    for dt in (torch.float32, torch.float64):
        x = torch.randn((1 << 20, 3), generator=g, device=dev, dtype=dt)
        x = x * torch.rand((1 << 20, 1), generator=g, device=dev,
                           dtype=dt) ** 8
        s = x.sum(-1)
        q = torch.randn((1 << 20, 4), generator=g, device=dev, dtype=dt)
        n, q2 = torch.linalg.vector_norm(q, dim=-1), q * q
        key = str(dt).split(".")[1]
        out[key] = dict(
            sum3_x0_x2_x1=float((s == (x[:, 0] + x[:, 2]) + x[:, 1])
                                .double().mean()),
            sum3_left_to_right=float((s == (x[:, 0] + x[:, 1]) + x[:, 2])
                                     .double().mean()),
            norm4_x02_x13=float((n == torch.sqrt(
                (q2[:, 0] + q2[:, 2]) + (q2[:, 1] + q2[:, 3])))
                .double().mean()),
            norm4_x01_x23=float((n == torch.sqrt(
                (q2[:, 0] + q2[:, 1]) + (q2[:, 2] + q2[:, 3])))
                .double().mean()))
    log(f"[merge] PyTorch's orders on the card: {out}")
    off = {k: {o: v[o] for o in MERGE_ORDERS if v[o] != 1.0}
           for k, v in out.items()}
    if any(off.values()):
        raise AssertionError(f"[merge] PyTorch no longer adds in the merge "
                             f"kernel's orders on every row: {off}")
    return out


def hold_merge(args, label: str) -> dict:
    """The merge kernel (``merge_kernel.merge_fresh``) against the plain
    merge on the card, on one call's inputs: every output leaf bit-equal,
    else each differing leaf with its count and largest gap."""
    import torch
    from edyn_tpu_torch.collision.kernels import merge_kernel as mk
    got = mk.merge_fresh(*args)
    want = mk.merge_fresh_plain(*args)
    diff = {}
    for f in mk.FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.is_floating_point():
            if bits_equal(a, b):
                continue
            it = torch.int64 if a.dtype == torch.float64 else torch.int32
            ne = a.view(it) != b.view(it)
        else:
            if torch.equal(a, b):
                continue
            ne = a != b
        gap = (a.double() - b.double()).abs()[ne]
        diff[f] = dict(n=int(ne.sum()), max_gap=float(gap.max()))
    man = args[1]
    return dict(label=label, slots=int(man.key.shape[0]),
                valid=int(man.valid.sum()),
                points_in=int(man.point_valid.sum()),
                points_out=int(want.point_valid.sum()),
                frozen=int(args[3].sum()), bit_equal=not diff,
                differing=diff)


def held_merges(held: list) -> list:
    """Logs each ``hold_merge`` result; raises, naming each differing leaf
    and its largest gap, unless every one is bit-equal."""
    for r in held:
        log(f"[merge] {r['label']}: {r['slots']} slots, {r['valid']} "
            f"valid, points {r['points_in']} -> {r['points_out']}, frozen "
            f"{r['frozen']}: "
            f"{'bit-equal' if r['bit_equal'] else r['differing']}")
    bad = [f"{r['label']}: {leaf} ({d['n']} elements, largest gap "
           f"{d['max_gap']})" for r in held
           for leaf, d in r["differing"].items()]
    if bad:
        raise AssertionError(f"[merge] the kernel differs from the plain "
                             f"merge: {'; '.join(bad)}")
    return held


class MergeWatch:
    """Inside ``with``: the step's merges (``narrowphase.merge_fresh``) run
    as always, and the inputs of every ``every``-th call of each shard and
    of the last call are kept. Keeping launches nothing, so the watched
    steps' times and launch counts stay their own. ``hold()`` then holds
    each kept merge to the plain merge (``held_merges``); ``last`` keeps
    the last call's inputs for ``time_merge``."""

    def __init__(self, label: str, every: int = MERGE_HELD_EVERY):
        self.label, self.every = label, every
        self.calls, self.kept, self.last = {}, [], None

    def __enter__(self):
        from edyn_tpu_torch.collision import narrowphase
        self._orig = narrowphase.merge_fresh
        narrowphase.merge_fresh = self._call
        return self

    def __exit__(self, *exc):
        from edyn_tpu_torch.collision import narrowphase
        narrowphase.merge_fresh = self._orig

    def _call(self, *args):
        from edyn_tpu_torch.utils import cuda_lib
        shard = getattr(cuda_lib._scope, "shard", None)
        n = self.calls[shard] = self.calls.get(shard, 0) + 1
        where = f"{self.label} step {n}" + (
            "" if shard is None else f" shard {shard}")
        if n % self.every == 0:
            self.kept.append((where, args))
        self.last = (where, args)
        return self._orig(*args)

    def hold(self) -> list:
        kept, self.kept = self.kept, []
        if self.last is not None and not (kept and kept[-1][1] is
                                          self.last[1]):
            kept.append(self.last)
        return held_merges([hold_merge(args, where) for where, args in kept])


def time_merge(args, label: str) -> dict:
    """The merge kernel's device time a launch (CUDA-graph replays; the
    inputs of one call move more than three times the L2 at every width
    timed here, so each replay reads them from device memory), one call
    with its host work, the plain merge's one call, and the byte bound."""
    import torch
    from edyn_tpu_torch.collision.kernels import merge_kernel as mk
    M = int(args[1].key.shape[0])
    per_slot = merge_slot_bytes(args[2].element_size())
    nbytes = M * per_slot
    if nbytes < 3 * L2_BYTES:
        raise AssertionError(f"[merge] {label}: {nbytes} bytes, under "
                             f"three times the L2: not timed cold")
    written = M * (per_slot - 10 - 4 * 14 * args[2].element_size()) // 2
    per_graph = max(2, min(20, int(4e9 // written)))
    ms = device_ms([lambda: mk.merge_fresh(*args)], per_graph=per_graph)
    call = call_ms(lambda: mk.merge_fresh(*args), 5)
    plain = call_ms(lambda: mk.merge_fresh_plain(*args), 3)
    torch.cuda.synchronize()
    b = bound(nbytes, 0.0)
    r = dict(label=label, slots=M, bytes_per_slot=per_slot,
             us=ms * 1e3, call_us=call * 1e3, plain_ms=plain,
             bound_us=b["bound_ms"] * 1e3,
             of_bound=b["bound_ms"] / ms)
    log(f"[merge] {label}: {M} slots, {r['us']:.2f} us a launch L2-cold "
        f"(bound {r['bound_us']:.2f}: {100 * r['of_bound']:.1f}%), one "
        f"call {r['call_us']:.2f} us; plain one call {plain:.2f} ms")
    return r


def watched_merges(watch: MergeWatch, label: str | None = None) -> dict:
    """``watch``'s held merges and, with ``label``, its last call timed."""
    out = dict(held=watch.hold())
    if label is not None:
        out["timed"] = time_merge(watch.last[1], label)
    watch.last = None
    return out


def phase14(dev) -> dict:
    """Phase 14: PyTorch's sum orders on the card (``sum_orders``); the
    merge kernel bit-equal to the plain merge on the crafted tables of
    ``collision/kernels/merge_cases.py`` (float32 and float64, each case's
    rule shown by the kernel's output too) and on the 65k drop of
    ``portbench/configs/pile65k.json`` at its ``max_pairs``, timed there
    L2-cold against its byte bound. Phases 3, 9, 12a and 13a hold the
    kernel on their own steps (``MergeWatch``)."""
    import dataclasses
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.collision.kernels import merge_cases
    from edyn_tpu_torch.collision.kernels import merge_kernel as mk
    from edyn_tpu_torch.utils.scenes import mixed_pile

    t0 = time.perf_counter()
    out = dict(sum_orders=sum_orders(dev), crafted=[])
    for dt in (torch.float32, torch.float64):
        for case in merge_cases.CASES:
            c = merge_cases.build(case, dt, device=dev)
            args = (c.bodies, c.table, c.new_pts, c.frozen, c.dt)
            r = hold_merge(args, f"{case} {str(dt)[6:]}")
            r["case_fails"] = merge_cases.check(case, c,
                                                mk.merge_fresh(*args))
            out["crafted"].append(r)
    held_merges(out["crafted"])
    fails = [f for r in out["crafted"] for f in r["case_fails"]]
    if fails:
        raise AssertionError(f"[merge] {fails}")

    # the 65k drop at its max_pairs, under the sweep after a dense step
    with open(MERGE_65K_CONFIG) as f:
        cfg = json.load(f)
    w = cfg["world"]
    world = et.make_world(
        mixed_pile(n_bodies=cfg["scene"]["n_bodies"], seed=0)[0],
        et.Settings(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in cfg["settings"].items()}),
        max_pairs=w["max_pairs"], device=dev)
    world.meta = dataclasses.replace(
        world.meta, max_rows=w["max_rows"], bucket_cap=w["bucket_cap"],
        broadphase_mode="dense")
    world.step(w["seat_dense_steps"])
    world.meta = dataclasses.replace(world.meta, broadphase_mode="sweep",
                                     sweep_window=w["sweep_window"])
    with MergeWatch("65k drop", every=60) as watch:
        world.step(MERGE_65K_STEPS)
    out["drop65k"] = watched_merges(watch, "65k drop")
    del watch, world
    out["build"] = build_info("merge_kernel", "merge_kernel")
    out["build_f64"] = build_info("merge_kernel", "merge_kernel", "double")
    out["seconds"] = time.perf_counter() - t0
    log(f"[phase 14] {len(out['crafted']) + len(out['drop65k']['held'])} "
        f"merges held, all bit-equal; registers {out['build']} / "
        f"{out['build_f64']}; {out['seconds']:.1f} s; gpu: {gpu_line()}")
    return out


def merge_entry(p14: dict, earlier: dict, launches: dict) -> dict:
    """The merge kernel's line of the kernel table; ``earlier`` holds the
    watched merges (``watched_merges``) of phases 3, 9, 12a and 13a by
    name. Every merge held was bit-equal, or the run stopped there."""
    runs = dict(earlier, drop65k=p14["drop65k"])
    t = {k: v["timed"] for k, v in runs.items() if "timed" in v}
    return dict(
        name="merge", route="cuda", source="edyn_tpu_torch/csrc/"
        "merge_kernel.cu", replaces=None, launches=launches.get("merge"),
        launches_per_step=(launches.get("merge") or 0) / STEPS,
        bit_equal=True, held=len(p14["crafted"]) + sum(
            len(v["held"]) for v in runs.values()),
        **{f"{k}_{m}": t[k][m] for k in t
           for m in ("slots", "us", "bound_us", "of_bound", "plain_ms")},
        **p14["build"])


def run_alone(phases, dev) -> None:
    """``--phases``: phases 8, 9, 10, 11, 12, 13 and 14 alone, in the order
    given, after the build (phase 12 after phase 3's main path, whose f32
    figures and landed pile it uses); their summaries are printed, the
    result lines are not."""
    out = {}
    for p in phases:
        if p == 8:
            out[8], _ = terrain_checks(dev)
        elif p == 9:
            out[9], _, _, bw, bids = asleep_path(N_BODIES, dev)
            inp, with_sr = real_inputs(bw)
            out["9_kernels"] = check_kernels(inp, with_sr,
                                             "mostly-asleep step")
            out["9_fused"] = check_fused(inp, with_sr, "mostly-asleep step")
            del inp
            out["9_live_api"] = live_api(bw, bids, dev)
            del bw
        elif p == 10:
            out[10], _ = paged_path(dev)
        elif p == 11:
            out[11], _ = networked_path(dev)
        elif p == 12:
            from edyn_tpu_torch.core.convert import state_to_numpy
            world, _, main = main_path(N_BODIES, STEPS, dev)
            landed = (state_to_numpy(world.state), world.meta,
                      world.settings)
            del world
            out[12], _, _ = phase12(dev, main, landed)
        elif p == 13:
            out[13], _ = phase13(dev)
        elif p == 14:
            out[14] = phase14(dev)
        else:
            raise SystemExit(f"--phases: phase {p} does not run alone")
    log(json.dumps(out, default=str))


def run(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="",
                    help="comma-separated phases among 8-14 "
                         "to run alone after the build (a rehearsal: no "
                         "result lines)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    from edyn_tpu_torch.core.convert import state_to_numpy
    from edyn_tpu_torch.utils import cuda_lib
    from edyn_tpu_torch.shapes.params import ShapeType
    from edyn_tpu_torch.utils.scenes import mixed_pile
    import edyn_tpu_torch as et

    # 1. device and build
    line = gpu_line()
    log(f"nvidia-smi: {line}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = cuda_lib.build_libraries(SOURCES, verbose=True)
    log(f"[build] {sorted(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    if args.phases:
        run_alone([int(p) for p in args.phases.split(",")], dev)
        return 0

    # 2. kernels against their plain versions at the main path's full width
    from edyn_tpu_torch.dynamics.solver_kernels import C_BASE, C_SR
    Rp_full = -(-16 * (N_BODIES + 5) // 128) * 128
    inp = random_inputs(C_BASE + C_SR, Rp_full, N_BODIES + 5, 0, dev)
    rand = check_kernels(inp, True, "random")
    fused_rand = check_fused(inp, True, "random", stress=True)
    del inp
    check_kernels(random_inputs(C_BASE, Rp_full, N_BODIES + 5, 1, dev),
                  False, "random, no spin/roll rows")
    fresh = et.make_world(mixed_pile(n_bodies=N_BODIES, seed=0)[0],
                          device=dev)
    tbl, dims = uk.pack_side_table_t(fresh.state)
    ka, kb = random_pairs(fresh.state.capacity, K4_PAIRS, 2, dev)
    k4_rand = [check_unified(tbl, ka, kb, dims, rim, "random pairs", False)
               for rim in (True, False)]
    del fresh, tbl, ka, kb
    k5_rand = check_overlaps(*random_aabbs(65_573, 3, dev), "random AABBs",
                             True)
    k5_edges = k5_edge_cases(dev)

    mark(2)

    # 3. the main path, the suggest_max_pairs entry point, and the JAX
    #    package's own pile test
    world, launches, main = main_path(N_BODIES, STEPS, dev)
    suggest = suggest_path(world)
    main["pile_of_60_lowest_centre"] = reference_pile(dev)

    mark(3)

    # 4. the kernels on a real step: the solver's table, the live UNIFIED
    #    pairs (against the plain version and against support_sat), the
    #    pile's AABBs
    inp, with_sr = real_inputs(world)
    real = check_kernels(inp, with_sr, "real step")
    fused_real = check_fused(inp, with_sr, "real step")
    del inp
    st = world.state
    tbl, dims = uk.pack_side_table_t(st)
    ka, kb = unified_pairs(st)
    rim = ShapeType.CYLINDER in world.meta.types_present  # as the step
    k4_real = check_unified(tbl, ka, kb, dims, rim, "real step", True)
    k4_real["vs_support_sat"] = versus_support_sat(st, ka, kb, rim)
    k5_real = check_overlaps(st.aabb_min.contiguous(),
                             st.aabb_max.contiguous(), st.valid, "real step",
                             False)
    # the landed pile, on the host, for phase 12's sweep
    landed = (state_to_numpy(st), world.meta, world.settings)
    del world, tbl, ka, kb, st

    mark(4)

    # 5. card against CPU; beside it, each in a process of its own (none
    #    times anything): phase 6's jointed card-vs-CPU check and the JAX
    #    package's ragdoll test, 12c (phase 5 at float64) and 13b (the JAX
    #    package's sharding cases)
    (versus, _), (joints_versus, one_ragdoll, f64_versus, jax_cases) = beside(
        [("joints_card_vs_cpu", "cuda"), ("reference_ragdoll", "cuda"),
         ("f64_card_vs_cpu", "cuda"), ("jax_cases_call", "cuda")],
        lambda: card_vs_cpu(dev))

    mark(5)

    # 6. joints: the ragdoll pile, the JAX package's ragdoll test, card
    #    against CPU on a settled jointed pile
    ragdolls, rag_launches, rag_world = ragdoll_path(N_RAGDOLLS, STEPS, dev)
    inp, with_sr = real_inputs(rag_world)
    rag_real = check_kernels(inp, with_sr, "ragdoll step")
    del inp
    st = rag_world.state
    tbl, dims = uk.pack_side_table_t(st)
    ka, kb = unified_pairs(st)
    rim = ShapeType.CYLINDER in rag_world.meta.types_present
    k4_rag = check_unified(tbl, ka, kb, dims, rim, "ragdoll step", True)
    k4_rag["vs_support_sat"] = versus_support_sat(st, ka, kb, rim,
                                                  "ragdoll step")
    del rag_world, tbl, ka, kb, st
    ragdolls["card_vs_cpu"] = joints_versus
    ragdolls["one_ragdoll"] = one_ragdoll

    mark(6)

    # 7. the terrain path: rich_scene at the bench's body count, then the
    #    path's kernels on its own step
    terrain, ter_launches, ter_world = terrain_path(N_TERRAIN, STEPS, dev)
    inp, with_sr = real_inputs(ter_world)
    ter_real = check_kernels(inp, with_sr, "terrain step")
    ter_fused = check_fused(inp, with_sr, "terrain step")
    del inp
    st = ter_world.state
    tbl, dims = uk.pack_side_table_t(st)
    ka, kb = unified_pairs(st)
    rim = ShapeType.CYLINDER in ter_world.meta.types_present
    k4_ter = check_unified(tbl, ka, kb, dims, rim, "terrain step", True)
    k4_ter["vs_support_sat"] = versus_support_sat(st, ka, kb, rim,
                                                  "terrain step")
    del ter_world, tbl, ka, kb, st

    mark(7)

    # 8. card against CPU on a settled terrain world (the whole step, then
    #    the mesh bucket alone, then the opt-in triangle cull); beside it,
    #    each in a process of its own, the vehicle, the JAX package's
    #    compound tests on the card and 13a (the sharded pile)
    checks8, (sharded,) = terrain_checks(
        dev, [("sharded_pile_call", "cuda", SHARD_STATE)])
    terrain.update(checks8)

    mark(8)

    # 9. bench.py's protocol on the 10k pile, the solver kernels at the
    #    mostly-asleep step's narrowed width, the live-world API
    bench, bench_launches, asleep_launches, bw, bids = asleep_path(
        N_BODIES, dev)
    inp, with_sr = real_inputs(bw)
    asleep_real = check_kernels(inp, with_sr, "mostly-asleep step")
    fused_asleep = check_fused(inp, with_sr, "mostly-asleep step")
    del inp
    bench["live_api"] = live_api(bw, bids, dev)
    del bw

    mark(9)

    # 10. PagedTerrain streaming on the card
    paged, paged_launches = paged_path(dev)

    mark(10)

    # 11. the networked path on the 10k pile: checkpoint resume, a server
    #     and two clients over bytes, the async worker, presentation
    networked, net_launches = networked_path(dev)

    mark(11)

    # 12. float64: the 10k pile under the float64 default dtype (K1-K5's
    #     double entries), those entries against their plain versions,
    #     card against CPU at f64; the sweep broadphase against the dense
    #     one on the landed pile and at the key limit
    phase_12, f64_launches, f64_entries = phase12(dev, main, landed,
                                                  f64_versus)
    del landed

    mark(12)

    # 13. the step sharded over the mesh: the 10k pile over 4 shards bit-
    #     equal to the unsharded step, each shard launching K1-K4; the JAX
    #     package's sharding cases; steps/s at k = 1, 2 and 4
    phase_13, shard_launches = phase13(dev, sharded, jax_cases)

    mark(13)

    # 14. the merge kernel against the plain merge: PyTorch's sum orders,
    #     the crafted tables, the 65k drop; timed there (phases 3, 9, 12a
    #     and 13a held it on their own steps)
    phase_14 = phase14(dev)

    mark(14)
    launch_sets = dict(launches=launches, ragdoll_launches=rag_launches,
                       terrain_launches=ter_launches,
                       bench_launches=bench_launches,
                       asleep_launches=asleep_launches,
                       paged_launches=paged_launches,
                       networked_launches=net_launches,
                       sharded_launches=shard_launches)
    kernels = [fused_entry(name, fused_real[name],
                           {"random": fused_rand[name],
                            "terrain": ter_fused[name],
                            "asleep": fused_asleep[name]},
                           {k: v[name] for k, v in launch_sets.items()},
                           unfused={"random": rand, "real": real,
                                    "terrain": ter_real,
                                    "asleep": asleep_real})
               for name in FUSED]
    for name in ("relvel",):
        r = rand[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE,
            replaces=KERNELS[name][0], launches=launches[name],
            launches_per_step=launches[name] / STEPS,
            ragdoll_launches=rag_launches[name],
            terrain_launches=ter_launches[name],
            bench_launches=bench_launches[name],
            asleep_launches=asleep_launches[name],
            paged_launches=paged_launches[name],
            networked_launches=net_launches[name],
            sharded_launches=shard_launches[name],
            max_abs_err=max(r["max_abs_err"], real[name]["max_abs_err"],
                            rag_real[name]["max_abs_err"],
                            ter_real[name]["max_abs_err"],
                            asleep_real[name]["max_abs_err"]),
            tol=f"{TOL} x (1 + |plain|)", ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_us=r["bound_ms"] * 1e3,
            bound_by=r["bound_by"], library_ms=None, warm_ms=r["warm_ms"],
            call_ms=r["call_ms"], C=r["C"], Rp=r["Rp"],
            real_Rp=real[name]["Rp"], real_ms=real[name]["ms"],
            real_warm_ms=real[name]["warm_ms"],
            real_call_ms=real[name]["call_ms"],
            real_bound_ms=real[name]["bound_ms"],
            ragdoll_max_abs_err=rag_real[name]["max_abs_err"],
            ragdoll_Rp=rag_real[name]["Rp"], ragdoll_ms=rag_real[name]["ms"],
            ragdoll_plain_ms=rag_real[name]["plain_ms"],
            ragdoll_bound_ms=rag_real[name]["bound_ms"],
            terrain_max_abs_err=ter_real[name]["max_abs_err"],
            terrain_Rp=ter_real[name]["Rp"], terrain_ms=ter_real[name]["ms"],
            terrain_plain_ms=ter_real[name]["plain_ms"],
            terrain_bound_ms=ter_real[name]["bound_ms"],
            asleep_max_abs_err=asleep_real[name]["max_abs_err"],
            asleep_Rp=asleep_real[name]["Rp"],
            asleep_ms=asleep_real[name]["ms"],
            asleep_plain_ms=asleep_real[name]["plain_ms"],
            asleep_bound_ms=asleep_real[name]["bound_ms"],
            **build_info("solver_kernels", SOLVER_KERNELS[name])))
    k4_all = k4_rand + [k4_real, k4_rag, k4_ter]
    k4_err = max(r["max_abs_err"] for r in k4_all)
    k4_tol = "equal to the plain version on every pair (signed zeros equal)"
    # K4: all of its wrapper's launches together (the main path pays all of
    # them), then each of its kernels alone
    kernels.append(dict(
        K4, route="cuda", launches=launches[K4["name"]],
        launches_per_step=launches[K4["name"]] / STEPS,
        ragdoll_launches=rag_launches[K4["name"]],
        terrain_launches=ter_launches[K4["name"]],
        bench_launches=bench_launches[K4["name"]],
        asleep_launches=asleep_launches[K4["name"]],
        paged_launches=paged_launches[K4["name"]],
        networked_launches=net_launches[K4["name"]],
            sharded_launches=shard_launches[K4["name"]],
        max_abs_err=k4_err, tol=k4_tol,
        within_tol=min(r["within_tol"] for r in k4_all),
        equal_pairs=sum(r["equal_pairs"] for r in k4_all),
        bit_equal_pairs=sum(r["bit_equal_pairs"] for r in k4_all),
        pairs=sum(r["pairs"] for r in k4_all),
        ms=k4_real["ms"], plain_ms=k4_real["plain_ms"],
        bound_ms=k4_real["bound_ms"], bound_us=k4_real["bound_ms"] * 1e3,
        bound_by=k4_real["bound_by"], bound_work="live",
        padded_bound_ms=k4_real["padded_bound_ms"], library_ms=None,
        warm_ms=k4_real["warm_ms"], call_ms=k4_real["call_ms"],
        main_ms=k4_real["main_ms"], features_ms=k4_real["features_ms"],
        order_ms=k4_real["order_ms"],
        order_library_ms=k4_real["order_library_ms"],
        table_order_main_ms=k4_real["table_order_main_ms"],
        includes=[k for ks in K4_STEPS.values() for k in ks],
        real_pairs=k4_real["pairs"], classes=k4_real["classes"],
        ragdoll_pairs=k4_rag["pairs"],
        ragdoll_max_abs_err=k4_rag["max_abs_err"],
        ragdoll_classes=k4_rag["classes"], ragdoll_ms=k4_rag["ms"],
        ragdoll_plain_ms=k4_rag["plain_ms"],
        ragdoll_bound_ms=k4_rag["bound_ms"],
        terrain_pairs=k4_ter["pairs"],
        terrain_max_abs_err=k4_ter["max_abs_err"],
        terrain_classes=k4_ter["classes"], terrain_ms=k4_ter["ms"],
        terrain_plain_ms=k4_ter["plain_ms"],
        terrain_bound_ms=k4_ter["bound_ms"],
        ops_per_pair=k4_real["ops_per_pair"],
        padded_ops_per_pair=k4_real["padded_ops_per_pair"],
        bytes=k4_real["bytes"], C=uk.table_rows(dims)))
    for step, names in K4_STEPS.items():
        r = k4_real["steps"][step]
        for kname in names:
            kernels.append(dict(
                name=kname, route="cuda", source=K4["source"],
                replaces=K4["replaces"], launches=launches[step],
                launches_per_step=launches[step] / STEPS,
                ragdoll_launches=rag_launches[step],
                terrain_launches=ter_launches[step],
                bench_launches=bench_launches[step],
                asleep_launches=asleep_launches[step],
                paged_launches=paged_launches[step],
                networked_launches=net_launches[step],
            sharded_launches=shard_launches[step],
                max_abs_err=k4_err if step == "collide_support" else 0.0,
                tol=k4_tol if step == "collide_support"
                else "bit-equal to the plain version",
                # the step's own time where the profiler recorded nothing
                ms=(k4_real["kernel_us"][kname] * 1e-3
                    if kname in k4_real["kernel_us"] else r["ms"]),
                timed_by=("torch.profiler, L2-cold input sets"
                          if kname in k4_real["kernel_us"] else
                          "CUDA graph of the whole step, L2-cold"),
                step=step, step_ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_us=r["bound_ms"] * 1e3,
                bound_by=r["bound_by"],
                padded_bound_ms=r.get("padded_bound_ms", r["bound_ms"]),
                library_ms=r.get("library_ms"),
                **build_info("unified_kernel", kname)))
    k5_all = [k5_rand, k5_real] + list(k5_edges.values())
    kernels.append(dict(
        K5, route="cuda", launches=suggest["launches"],
        ragdoll_launches=rag_launches["count_overlaps"],
        terrain_launches=ter_launches["count_overlaps"],
        bench_launches=bench_launches["count_overlaps"],
        asleep_launches=asleep_launches["count_overlaps"],
        paged_launches=paged_launches["count_overlaps"],
        networked_launches=net_launches["count_overlaps"],
            sharded_launches=shard_launches["count_overlaps"],
        max_abs_err=max(r["max_abs_err"] for r in k5_all),
        tol="exact", ms=k5_rand["ms"], plain_ms=k5_rand["plain_ms"],
        bound_ms=k5_rand["bound_ms"], bound_us=k5_rand["bound_ms"] * 1e3,
        bound_by=k5_rand["bound_by"], library_ms=None,
        warm_ms=k5_rand["warm_ms"], call_ms=k5_rand["call_ms"],
        n=k5_rand["n"], real_n=k5_real["n"], real_count=k5_real["count"],
        edge_cases={k: v["count"] for k, v in k5_edges.items()},
        **build_info("overlap_count", "overlap_kernel")))
    kernels += f64_entries
    kernels.append(merge_entry(
        phase_14, dict(pile=main["merge"], asleep=bench["merge"],
                       f64=phase_12["f64"]["merge"],
                       sharded=phase_13["sharded_pile"]["merge"]),
        launches))
    log(json.dumps({"main_path": main, "suggest_max_pairs": suggest,
                    "fused": {"random": fused_rand, "real": fused_real,
                              "terrain": ter_fused, "asleep": fused_asleep},
                    "k4": {"random": k4_rand, "real": k4_real},
                    "k5": {"random": k5_rand, "real": k5_real,
                           "edge_cases": k5_edges},
                    "card_vs_cpu": versus, "ragdolls": ragdolls,
                    "ragdoll_kernels": {"solver": rag_real, "k4": k4_rag},
                    "terrain": terrain,
                    "terrain_kernels": {"solver": ter_real, "k4": k4_ter},
                    "bench": bench, "asleep_kernels": asleep_real,
                    "paged": paged, "networked": networked,
                    "phase_12": phase_12, "phase_13": phase_13,
                    "phase_14": phase_14}))
    log(f"gpu: {line}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
