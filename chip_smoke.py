#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``edyn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the run then exits non-zero and
prints no result):

1. Device and build: the card's name and power limit from ``nvidia-smi``,
   then ``nvcc`` builds ``edyn_tpu_torch/csrc/solver_kernels.cu``.
2. Kernels against their plain PyTorch versions on the card, on random
   inputs at the main path's full width (C = 97 table rows, Rp = 160,128):
   max abs difference, the kernel's device time with its inputs read from
   device memory and with them in L2 (CUDA-graph replays), the plain
   version's, one call with its host work, and the memory bound.
3. The main path: ``mixed_pile(10_000)`` -> ``make_world`` (cuda) ->
   ``World.step_n(120)``, with every kernel's launch count set to 0 just
   before and read just after. Checks finite state, launch counts within
   (0, per-step maximum x steps], and the pile checks of the JAX package's
   ``test_mixed_pile_settles_and_no_tunnel`` (see ``FLOOR_BURIAL``); then
   that test itself, a 60-body pile settled for 240 steps, on the card.
4. The kernels again on the packed row table of a real step of that pile.
5. Card against CPU: one step of a settled 1,000-body pile, on the card
   and from a copy on the CPU (plain versions), held per body at the
   whole-step tolerances of the test suite (see ``card_vs_cpu``).

The line before the last is one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet): device memory rate and float32 rate
# outside the tensor cores. The bound of a kernel is the larger of its bytes
# over the memory rate and its operations over the float32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
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
TOL = 1e-5  # |kernel - plain| <= TOL * (1 + |plain|): same rounding, f32
# the main path: the bench's pile, stepped until most of it has landed
N_BODIES = 10_000
STEPS = 120


def log(*a):
    print(*a, flush=True)


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
    t[64] = (u(Rp) > 0.2).float()               # ngs_valid
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
                         (u(Rp) > 0.3).float()]).contiguous())


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


def check_kernels(inp, with_sr: bool, label: str) -> dict:
    """Hold every kernel against its plain version; time both.

    ``ms`` and ``plain_ms`` are L2-cold: the graph cycles through copies of
    the inputs that together move at least three times the L2's size, so
    every launch reads its inputs from device memory, as the bound assumes.
    ``warm_ms`` replays the kernel on one input set, which stays in L2 when
    it fits."""
    import torch
    from edyn_tpu_torch.dynamics import solver_kernels as sk
    C, Rp = inp["tbl"].shape
    out = {}
    for name, (kern, plain) in kernel_calls(inp, with_sr).items():
        err = max_err(name, kern(), plain())
        torch.cuda.synchronize()
        _, extra_in, n_out, flops = KERNELS[name]
        nbytes = 4 * Rp * (sk.rows_read(name, with_sr) + extra_in + n_out)
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
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         warm_ms=warm_ms, call_ms=per_call,
                         bound_ms=1e3 * max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", bytes=nbytes, C=C, Rp=Rp)
        log(f"[{label}] {name}: C={C} Rp={Rp} max_abs_err={err:.3g} "
            f"(tol {TOL} x (1+|plain|)); device {ms * 1e3:.2f} us L2-cold "
            f"({n_sets} input sets), {warm_ms * 1e3:.2f} us L2-warm; plain "
            f"{plain_ms * 1e3:.2f} us; bound "
            f"{out[name]['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.2f} MB); "
            f"one call with its host work {per_call * 1e3:.1f} us")
    return out


def main_path(n_bodies: int, steps: int, dev):
    """Phase 3: the port's main path through the user-facing entry points."""
    import torch
    import edyn_tpu_torch as et
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
    t0 = time.perf_counter()
    first = max(1, steps - 20)
    world.step_n(first)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    world.step_n(steps - first)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(sk.LAUNCHES)

    st = world.state
    s = world.settings
    per_step = {"solve_iteration": s.num_solver_velocity_iterations,
                "ngs_iteration": s.num_solver_position_iterations,
                "restitution_iteration": s.num_restitution_iterations
                * s.num_individual_restitution_iterations,
                "relvel": s.num_restitution_iterations}
    awake = int((st.awake_dynamic).sum())
    rows_count = rows_in_use(world)
    log(f"[main] {steps} steps in {t2 - t0:.3f} s = "
        f"{steps / (t2 - t0):.3f} steps/s; first {first}: "
        f"{first / (t1 - t0):.3f} steps/s, last {steps - first}: "
        f"{(steps - first) / (t2 - t1):.3f} steps/s")
    log(f"[main] rows.count {rows_count}, awake bodies {awake}, overflow "
        f"{world.overflow_counters()}, launches {launches}")

    for name, n in launches.items():
        if not 0 < n <= per_step[name] * steps:
            raise AssertionError(f"{name}: {n} launches in {steps} steps, "
                                 f"expected 1..{per_step[name] * steps}")
    lowest = check_pile(st, -FLOOR_BURIAL, "main")
    log(f"[main] max_pairs grew to {world.meta.max_pairs}")
    return world, launches, dict(
        steps=steps, seconds=t2 - t0, steps_per_s=steps / (t2 - t0),
        last_steps_per_s=(steps - first) / (t2 - t1), rows_count=rows_count,
        awake=awake, overflow=world.overflow_counters(),
        max_pairs=world.meta.max_pairs, lowest_centre=lowest)


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
    body velocities."""
    import torch
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
                     ((tbl[55:56] > 0.5) & (relv < -0.005)).float()])
    return dict(tbl=tbl, imp=imp6.T.contiguous(),
                imp3=imp6[:, :3].T.contiguous(), g=g,
                dyn=dyn.contiguous()), rows.sA_n is not None


def _to(x, dev):
    """A state, table or row structure with every tensor moved to dev."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dev)
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


def _nudged(tree, seed=None, mask=None, ulps: int = 1, up: bool = True):
    """A copy of a numpy state tree with body positions moved by ``ulps``
    float32 ulps: those under ``mask`` all one way (``up`` or down), or,
    with a ``seed``, every body's each coordinate a random way."""
    import numpy as np
    pos = tree["pos"]
    if seed is not None:
        rise = np.random.default_rng(seed).random(pos.shape) < 0.5
        mask = np.ones(len(pos), bool)
    else:
        rise = np.full(pos.shape, up)
    new = pos.copy()
    for _ in range(ulps):
        new = np.where(rise, np.nextafter(new, np.float32(np.inf)),
                       np.nextafter(new, np.float32(-np.inf)))
    return dict(tree, pos=np.where(mask[:, None], new, pos).astype(
        np.float32))


def card_vs_cpu(dev, n_bodies: int = 1000, settle: int = 240):
    """Phase 5: one whole step of a settled pile in contact, on the card and
    from a copy of its state on the CPU (the kernels' plain versions), held
    per body at the whole-step tolerances with the rule of
    tests/test_torch_step.py's ``check_step``.

    The card's float sums, matrix products, sqrt and sin round differently
    from the CPU's (scripts/torch_device_diff.py), and contact generation
    turns some 1-ulp differences into another contact point set, or a
    contact kept or dropped (ROADMAP.md queue 3, P1 and P2). So a body
    outside the tolerances passes only where the CPU step itself is that
    sensitive: its difference must be at most twice the largest change that
    a 1-ulp perturbation of the start state makes to the CPU step there.
    The perturbations: the positions of the bodies outside the tolerances
    moved 1 and 2 ulps up and down (``check_step``'s), and every position
    moved 1 ulp a random way, four times. The pile is settled for 240 steps
    (the JAX package's test_mixed_pile_settles_and_no_tunnel) because while
    it still lands, a 1-ulp perturbation moves half its bodies past the
    tolerances.

    Also held exactly: the pair lists and island labels. And the solve
    phase alone, run on both devices from the CPU's contact rows, at the
    whole-step tolerances."""
    import numpy as np
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.core.convert import state_from_numpy, state_to_numpy
    from edyn_tpu_torch.dynamics.solver import rows_prefix
    from edyn_tpu_torch.simulation import stepper
    from edyn_tpu_torch.utils.scenes import mixed_pile

    builder, _ = mixed_pile(n_bodies=n_bodies, seed=1)
    w = et.make_world(builder, et.Settings(), device=dev)
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
        (mc.pivot_a - mp.pivot_a).abs().amax((1, 2)) < 1e-4))).sum())

    # the solve phase from the CPU's rows on both devices
    st, man, rows, _ = cpu
    width = stepper.solve_width(rows, meta)
    if width < rows.valid.shape[0]:
        rows = rows_prefix(rows, width)
    use_rest = s.num_restitution_iterations > 0
    got = stepper._solve_phase(_to(st, dev), _to(man, dev), _to(rows, dev),
                               s, use_rest)
    want = stepper._solve_phase(st, man, rows, s, use_rest)
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
        alts = [_nudged(tree, mask=bad, ulps=k, up=up)
                for k in (1, 2) for up in (True, False)]
        alts += [_nudged(tree, seed=k) for k in range(4)]
        for t in alts:
            c = cpu_step(t)
            for f in sens:
                sens[f] = np.maximum(sens[f], np.abs(c[f] - b[f]))
        for f, rtol, atol in STEP_TOL:
            over = bad[:, None] & (diff[f] > np.maximum(
                atol + rtol * np.abs(b[f]), 2 * sens[f]))
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
    log(f"[card-vs-cpu] {n_bodies} bodies after {settle} steps: pair lists "
        f"and islands equal; {n_live} live manifolds, {other_pts} with "
        f"another point set; solve phase from the same rows max abs diff "
        f"{solve}; whole step max abs diff {full}, {int(bad.sum())} of "
        f"{n_dyn} bodies outside the tolerances, each within twice the CPU "
        f"step's 1-ulp sensitivity (largest there {largest})")
    return dict(settle=settle, live_manifolds=n_live,
                point_sets_differ=other_pts, solve=solve, full_step=full,
                bodies_outside_tol=int(bad.sum()), dynamic_bodies=n_dyn)


def run() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from edyn_tpu_torch.dynamics import solver_kernels as sk

    # 1. device and build
    line = gpu_line()
    log(f"nvidia-smi: {line}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = sk.build_library(verbose=True)
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")

    # 2. kernels against their plain versions at the main path's full width
    from edyn_tpu_torch.dynamics.solver_kernels import C_BASE, C_SR
    Rp_full = -(-16 * (N_BODIES + 5) // 128) * 128
    rand = check_kernels(random_inputs(C_BASE + C_SR, Rp_full, N_BODIES + 5,
                                       0, dev), True, "random")
    check_kernels(random_inputs(C_BASE, Rp_full, N_BODIES + 5, 1, dev),
                  False, "random, no spin/roll rows")

    # 3. the main path, and the JAX package's own pile test
    world, launches, main = main_path(N_BODIES, STEPS, dev)
    main["pile_of_60_lowest_centre"] = reference_pile(dev)

    # 4. the kernels on a real step's table
    inp, with_sr = real_inputs(world)
    real = check_kernels(inp, with_sr, "real step")
    del world, inp

    # 5. card against CPU
    versus = card_vs_cpu(dev)

    kernels = []
    for name, r in rand.items():
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE,
            replaces=KERNELS[name][0], launches=launches[name],
            max_abs_err=max(r["max_abs_err"], real[name]["max_abs_err"]),
            tol=f"{TOL} x (1 + |plain|)", ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_us=r["bound_ms"] * 1e3,
            bound_by=r["bound_by"], library_ms=None, warm_ms=r["warm_ms"],
            call_ms=r["call_ms"], C=r["C"], Rp=r["Rp"],
            real_Rp=real[name]["Rp"], real_ms=real[name]["ms"],
            real_warm_ms=real[name]["warm_ms"],
            real_call_ms=real[name]["call_ms"],
            real_bound_ms=real[name]["bound_ms"]))
    log(json.dumps({"main_path": main, "card_vs_cpu": versus}))
    log(f"gpu: {line}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
