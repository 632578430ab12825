"""Readings of a jointed world before it has a cell: the ragdoll pile of
``chip_smoke.ragdoll_pile`` (upstream edyn's rig, ``utils/ragdoll.py``, on a
grid in a plane-walled bin, at ``chip_smoke.ragdoll_settings()``) stepped
``--frames`` frames through the program on the card; every frame judged by
``reference.semantics`` (the program, the float32 witness and the bfloat16
control; its description is read off the program's builder); the frozen
reference stepped once from the program's state at ``--ref-frames`` (and
its bfloat16 control at the last); the step's spans from
``--record-from`` on. One JSON line a seed, with each frame's free groups
and gaps under ``per_frame``.

    python3 portbench/tools/ragdolls.py --ragdolls 768 --frames 120 \
        --seeds 0 1 2
"""
import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[0:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

import numpy as np  # noqa: E402
import torch  # noqa: E402


def describe(et, b) -> dict:
    """The scene description (``harness.scene``) of a program builder of
    planes, spheres, boxes and capsules (each with its centre of mass at
    its origin) and point, cone and hinge joints."""
    from edyn_tpu_torch.constraints.joints import JointType
    kinds = {JointType.POINT: "point", JointType.CONE: "cone",
             JointType.HINGE: "hinge"}
    planes, bodies = [], []
    for d in b.defs:
        if isinstance(d.shape, et.PlaneShape):
            planes.append((tuple(d.shape.normal), float(d.shape.constant)))
        else:
            bodies.append(d)
    s = len(planes)
    if any(isinstance(d.shape, et.PlaneShape) for d in b.defs[s:]):
        raise ValueError("the planes must come first")
    n = len(bodies)
    radius, inertia = np.zeros(n), np.full((n, 3), np.nan)
    for i, d in enumerate(bodies):
        sh, m = d.shape, float(d.mass)
        if isinstance(sh, et.SphereShape):
            radius[i] = sh.radius
            inertia[i] = 1 / (0.4 * m * sh.radius ** 2)
        elif isinstance(sh, et.BoxShape):
            h = np.asarray(sh.half_extents, np.float64)
            radius[i] = np.linalg.norm(h)
            h2 = np.square(2 * h)
            inertia[i] = 12 / (m * (h2.sum() - h2))
        elif isinstance(sh, et.CapsuleShape):
            radius[i] = sh.radius + sh.half_length
        else:
            raise ValueError(type(sh))
    joints = [dict(type=kinds[JointType(int(j["jtype"]))],
                   a=int(j["body_a"]) - s, b=int(j["body_b"]) - s,
                   pivot_a=tuple(j["pivot_a"]), pivot_b=tuple(j["pivot_b"]))
              for j in b.joints]
    return dict(
        scene="ragdolls", planes=planes,
        pos=np.array([d.position for d in bodies], np.float64),
        orn=np.array([d.orientation for d in bodies], np.float64),
        radius=radius, mass=np.array([d.mass for d in bodies], np.float64),
        inertia_inv=inertia,
        material=dict(
            friction=np.array([d.material.friction for d in bodies]),
            restitution=np.array([d.material.restitution for d in bodies]),
            roll_friction=np.array([d.material.roll_friction
                                    for d in bodies])),
        joints=joints)


def replay(et, engine, b):
    """The program builder's bodies, exclusions and joints in a reference
    builder."""
    shapes = dict(SphereShape=lambda s: engine.SphereShape(s.radius),
                  BoxShape=lambda s: engine.BoxShape(tuple(s.half_extents)),
                  CapsuleShape=lambda s: engine.CapsuleShape(
                      s.radius, s.half_length, axis=s.axis),
                  PlaneShape=lambda s: engine.PlaneShape(tuple(s.normal),
                                                         s.constant))
    r = engine.WorldBuilder()
    for d in b.defs:
        m = d.material
        r.make_rigidbody(engine.RigidBodyDef(
            kind=d.kind, position=tuple(d.position),
            orientation=tuple(d.orientation), mass=d.mass,
            shape=shapes[type(d.shape).__name__](d.shape),
            material=engine.Material(
                restitution=m.restitution, friction=m.friction,
                spin_friction=m.spin_friction,
                roll_friction=m.roll_friction, stiffness=m.stiffness,
                damping=m.damping, id=m.id),
            collision_group=d.collision_group,
            collision_mask=d.collision_mask))
    for a, c in b.exclusions:
        r.exclude_collision(a, c)
    for j in b.joints:
        r._add_joint(**{k: (int(v) if k == "jtype" else v)
                        for k, v in j.items()})
    return r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ragdolls", type=int, default=768)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--ref-frames", type=int, nargs="+",
                    default=[0, 40, 80, 119])
    ap.add_argument("--record-from", type=int, default=90)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    import chip_smoke
    import edyn_tpu_torch as et
    from edyn_tpu_torch.utils import profile
    from harness import runner, window
    from reference import compare, engine, semantics
    dev = torch.device(a.device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    card = runner.power_limit() if cuda else "cpu"
    for seed in a.seeds:
        out = dict(seed=seed, card=card, ragdolls=a.ragdolls)
        t0 = time.perf_counter()
        b, _ = chip_smoke.ragdoll_pile(et, a.ragdolls, seed)
        desc = describe(et, b)
        settings = chip_smoke.ragdoll_settings()
        w = et.make_world(b, settings, device=dev)
        sync()
        out.update(build_s=time.perf_counter() - t0,
                   bodies=len(desc["pos"]), joints=len(desc["joints"]),
                   max_pairs=w.meta.max_pairs)
        built = w.state
        g = list(settings.gravity)
        dt = settings.fixed_dt
        out["start_bodies_differ"] = semantics.start(
            desc, g, {f: getattr(built, f).cpu().numpy()
                      for f in semantics.START_FIELDS})["start_bodies_differ"]
        frames, samples, step_s = [], [], []
        profile.reset()
        for k in range(a.frames):
            pre = w.state
            pre_host = runner.semantic_input(pre)
            meta = w.meta
            t1 = time.perf_counter()
            with (profile.enable() if k >= a.record_from
                  else contextlib.nullcontext()):
                w.step()
            post = w.state
            host = torch.cat([post.pos, post.orn], 1).cpu().numpy()
            step_s.append(time.perf_counter() - t1)
            vel = (post.linvel.cpu().numpy(), post.angvel.cpu().numpy())
            frames.append((pre_host, host, vel))
            if k in a.ref_frames:
                samples.append(window.Sample(k, pre, meta,
                                             (post.linvel, post.angvel),
                                             host))
            if int(post.overflow.abs().sum()) or w.meta is not meta:
                out.setdefault("overflow_frames", []).append(k)
        rec = profile.recorded()
        steps = rec["steps"]
        out["span_ms_per_frame"] = {
            name: v["device_ms"] / steps for name, v in rec["spans"].items()
            if name in ("step", "solve", "joint_rows", "joint_warm_start",
                        "joint_velocity", "joint_positions", "velocity",
                        "position", "narrowphase", "broadphase", "rows",
                        "islands", "warm_start")} if steps else None
        out["recorded_steps"] = steps
        out["host_syncs_per_step"] = {
            k: v / steps for k, v in rec["counters"].items()
            if k == "host_syncs" or k.startswith("host_syncs.joints")} \
            if steps else None
        out["frame_ms"] = dict(
            median=1e3 * float(np.median(step_s)),
            first=1e3 * step_s[0],
            by_tenth=[1e3 * float(np.mean(step_s[i * len(step_s) // 10:
                                                 (i + 1) * len(step_s) // 10]))
                      for i in range(10)])
        per = []
        t1 = time.perf_counter()
        for k, (pre_host, host, vel) in enumerate(frames):
            j = semantics.judge(desc, g, dt, pre_host, host, vel)
            per.append([k, j["free_groups"], j["free_bodies"],
                        j["quiet_bodies"], j["free_group_pos_gap_m"],
                        j["free_group_linvel_gap_mps"],
                        j["joint_pivot_gap_m"]])
        out["judge_all_s"] = time.perf_counter() - t1
        out["per_frame"] = per
        for mode, dtype in (("program", np.float64), ("witness", np.float32),
                            ("control", "bfloat16")):
            t1 = time.perf_counter()
            out[mode] = semantics.check(desc, g, dt, frames, dtype)
            out[mode]["seconds"] = time.perf_counter() - t1
        # the check as a run makes it: the first frame, two others, the last
        t1 = time.perf_counter()
        four = [frames[0], frames[40], frames[80], frames[-1]] \
            if len(frames) > 80 else frames
        out["check4"] = semantics.check(desc, g, dt, four)
        out["check4"]["seconds"] = time.perf_counter() - t1
        del frames
        # the frozen reference: its own build of the replayed builder, then
        # one step from the program's state at each sampled frame
        t1 = time.perf_counter()
        rb = replay(et, engine, b)
        rw = engine.make_world(rb, engine.Settings(**{
            f: getattr(settings, f) for f in (
                "fixed_dt", "gravity", "num_solver_velocity_iterations",
                "num_solver_position_iterations",
                "num_restitution_iterations",
                "num_individual_restitution_iterations", "mass_splitting",
                "enable_sleeping", "collision_threshold",
                "cone_max_violation")}), device=dev)
        sync()
        out["ref_build_s"] = time.perf_counter() - t1
        out["start_leaves_differ"] = compare.leaves_differ(built, rw.state)
        out["meta_fields_differ_at_build"] = compare.meta_differ(
            samples[0].meta, rw.meta)
        del built, w, pre, post
        t1 = time.perf_counter()
        ref = {}
        for smp in samples:
            t2 = time.perf_counter()
            one = compare.check_frames([smp], rw)
            sync()
            one["seconds"] = time.perf_counter() - t2
            ref[smp.frame] = one
        out["reference"] = ref
        out["reference_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["reference_control"] = compare.check_frames(samples[-1:], rw,
                                                        control=True)
        out["reference_control"]["seconds"] = time.perf_counter() - t1
        out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                             if cuda else 0)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del samples, rw, rb
        if cuda:
            torch.cuda.empty_cache()
    found = runner.forbidden_modules()
    print(json.dumps(dict(forbidden_modules=found)), flush=True)


if __name__ == "__main__":
    main()
