"""The reference, its control and the faults it must catch, on the CPU at
a small size (the control at each cell's own size runs on the card:
``portbench/tools/calibrate.py``)."""
from __future__ import annotations

import dataclasses
import json
import time

import pytest
import torch

from conftest import (BENCH, CELLS, JOINT_LIMITS, falling_frame,
                      jointed_bench, small_bench)


def _limits(cell):
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())


def test_reference_steps_the_pile_as_the_program_does_on_the_cpu():
    """The reference's own world of a 60-body seeded pile, stepped 60 times
    on the CPU (where the program takes its plain versions too), equals
    the program's at every step, and the pile lands on the floor."""
    import edyn_tpu_torch as et
    from harness import scene
    from reference import compare, engine
    desc = scene.mixed_pile(60, 2**31 + 3)
    bp, _ = scene.build(et, desc)
    br, _ = scene.build(engine, desc)
    wp = et.make_world(bp, et.Settings(), device="cpu")
    wr = engine.make_world(br, engine.Settings(), device="cpu")
    assert compare.leaves_differ(wp.state, wr.state) == 0
    for _ in range(60):
        wp.step()
        wr.step()
        assert compare.leaves_differ(wp.state, wr.state) == 0
    st = wr.state
    assert int(st.contacts.point_valid.sum()) > 0
    assert float(st.pos[st.is_dynamic][:, 1].min()) > 0.0


def _chains():
    from harness import spec
    return spec.load_module(BENCH / "tests" / "scenes" / "chains.py",
                            "portbench_test_chains")


def test_reference_steps_a_jointed_world_as_the_program_does_on_the_cpu():
    """The reference's own world of four jointed chains (point, cone and
    hinge joints, ``tests/scenes/chains.py``), stepped 60 times on the CPU
    through the fall and the landing, equals the program's at every step:
    the joint rows, their warm start, the joint solve after each velocity
    iteration and the joints' position correction, with the cone's cap."""
    import edyn_tpu_torch as et
    from reference import compare, engine
    chains = _chains()
    desc = chains.describe(2**31 + 5, n_chains=4, height=1.7, stagger=0.6)
    bp, _ = chains.build(et, desc)
    br, _ = chains.build(engine, desc)
    wp = et.make_world(bp, et.Settings(cone_max_violation=2.0), device="cpu")
    wr = engine.make_world(br, engine.Settings(cone_max_violation=2.0),
                           device="cpu")
    assert wr.meta.joint_types == wp.meta.joint_types == {
        engine.constraints.joints.JointType.POINT,
        engine.constraints.joints.JointType.CONE,
        engine.constraints.joints.JointType.HINGE}
    assert compare.leaves_differ(wp.state, wr.state) == 0
    for _ in range(60):
        wp.step()
        wr.step()
        assert compare.leaves_differ(wp.state, wr.state) == 0
    st = wr.state
    assert int(st.contacts.point_valid.sum()) > 0
    assert float(st.joints.impulses.abs().max()) > 0


def test_the_reference_refuses_a_joint_it_does_not_step():
    """A world with a joint type the copy has not taken (here a distance
    joint) is refused, not stepped without it."""
    from reference import engine
    chains = _chains()
    desc = chains.describe(3, n_chains=1)
    b, _ = chains.build(engine, desc)
    b._add_joint(jtype=engine.constraints.joints.JointType.DISTANCE,
                 body_a=5, body_b=6, params=(0.3,))
    w = engine.make_world(b, engine.Settings(), device="cpu")
    with pytest.raises(ValueError, match="point, cone and hinge"):
        w.step()


@pytest.mark.parametrize("world", ["pile", "chains"])
def test_dynamic_fields_cover_what_a_step_changes(world):
    """Every state field outside ``compare.DYNAMIC`` (and, of the joints,
    outside ``compare.DYNAMIC_JOINT``) is the same after 40 steps as when
    built: the reference's own build may stand for it."""
    from harness import scene
    from reference import compare, engine
    if world == "pile":
        b, _ = scene.build(engine, scene.mixed_pile(60, 5))
        settings = engine.Settings()
    else:
        chains = _chains()
        b, _ = chains.build(engine, chains.describe(5, n_chains=2,
                                                    height=1.7))
        settings = engine.Settings(cone_max_violation=2.0)
    w = engine.make_world(b, settings, device="cpu")
    built = w.state
    w.step(40)
    static = dataclasses.replace(
        w.state, **{f: getattr(built, f) for f in compare.DYNAMIC},
        joints=dataclasses.replace(w.state.joints, **{
            f: getattr(built.joints, f) for f in compare.DYNAMIC_JOINT}))
    assert compare.leaves_differ(static, built) == 0


def _run(tmp_path, traffic="drop", seconds=1.5, limits_of="pile10k.drop"):
    from harness import runner, spec
    dst = small_bench(tmp_path, traffic, limits_of=limits_of)
    cell = spec.load_cell(f"small.{traffic}", dst)
    return runner.run_cell(cell, 2**31 + 29, seconds, False, "cpu",
                           time.perf_counter(), log=lambda line: None)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_every_cell(cell):
    """The control (the references in bfloat16 in the program's place) on
    a small pile, 40 frames from the drop, fails at least one of the cell's
    limits; the float32 reference's own frame passes them all."""
    from harness import runner, scene, traffic, window
    from reference import compare, semantics
    cfg = json.loads((BENCH / "configs" / "pile10k.json").read_text())
    cfg["scene"] = dict(cfg["scene"], n_bodies=60)
    cfg["world"] = dict(cfg["world"], max_pairs=4096, max_rows=4096,
                        bucket_cap=2048)
    desc = scene.mixed_pile(60, 41)
    w = compare.reference_world(cfg, desc, torch.device("cpu"))
    frames = []
    for k in (0, 40):            # the window's first frame and a later one
        if k:
            w.step(k - 1)        # to step k, after frame 0's own step
        pre = w.state
        w.step()
        s = window.Sample(k, pre, w.meta, (w.state.linvel, w.state.angvel),
                          traffic.readback(w.state))
        frames.append((runner.semantic_input(pre), s.host,
                       tuple(v.numpy() for v in s.post_vel)))
    st = cfg["settings"]
    numbers = compare.check_frames([s], w, control=True)
    numbers.update(semantics.check(desc, st["gravity"], st["fixed_dt"],
                                   frames, "bfloat16"))
    numbers["start_leaves_differ"] = 0
    numbers["meta_fields_differ"] = 0
    ok, _ = compare.verdict(numbers, _limits(cell))
    assert not ok
    sound = compare.check_frames([s], w)
    assert all(sound[k] == 0 for k in compare.GAPS)
    sound.update(semantics.check(desc, st["gravity"], st["fixed_dt"],
                                 frames))
    sound.update(start_leaves_differ=0, meta_fields_differ=0,
                 start_bodies_differ=0)
    assert compare.verdict(sound, _limits(cell))[0]


def _unchanged(step):
    return lambda state, settings, meta: state


def _half(step):
    def half(state, settings, meta):
        out = step(state, settings, meta)
        keep = torch.arange(state.capacity) % 2 == 1
        return dataclasses.replace(out, **{
            f: torch.where(keep[:, None], getattr(state, f), getattr(out, f))
            for f in ("pos", "orn", "linvel", "angvel")})
    return half


def _altered(step):
    def altered(state, settings, meta):
        out = step(state, settings, meta)
        pos = out.pos.clone()
        pos[-1, 1] += 0.5
        return dataclasses.replace(out, pos=pos)
    return altered


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_the_bodies",
                              "answer_altered"])
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, fault):
    """The rest of a run, with the program's step broken underneath, reads
    ``correct`` false. (The exchange between chips: no cell runs on more
    than one.)"""
    from edyn_tpu_torch.core import world as world_mod
    monkeypatch.setattr(world_mod, "physics_step",
                        fault(world_mod.physics_step))
    res = _run(tmp_path)
    assert res["correct"] is False


def _skip(name):
    if name == "solve_joints_once":
        return lambda rows, impulses, dvw: (impulses, dvw)
    return lambda state, *args, **kwargs: state


@pytest.mark.parametrize("phase", [None, "solve_joints_once",
                                   "solve_joint_positions"],
                         ids=["sound", "no_joint_velocity",
                              "no_joint_positions"])
def test_a_step_without_a_joint_phase_is_not_correct(tmp_path, monkeypatch,
                                                     phase):
    """A jointed cell added as new files (``jointed_bench``): the sound
    step is ``correct``; a step that leaves out the joint solve of the
    velocity iterations, or the joints' position correction, is not."""
    from edyn_tpu_torch.constraints import joints
    from harness import runner, spec
    if phase:
        monkeypatch.setattr(joints, phase, _skip(phase))
    dst = jointed_bench(tmp_path)
    cell = spec.load_cell("chains.landing", dst)
    res = runner.run_cell(cell, 2**31 + 61, 0.5, False, "cpu",
                          time.perf_counter(), log=lambda line: None)
    assert res["correct"] is (phase is None), res["check"]


def test_a_sound_run_is_correct(tmp_path):
    assert _run(tmp_path)["correct"] is True


def test_a_sound_asleep_run_is_correct(tmp_path):
    assert _run(tmp_path, "asleep", limits_of="pile10k.asleep")[
        "correct"] is True


@pytest.mark.parametrize("fault", [None, "unchanged", "no_gravity",
                                   "spin_dropped", "quiet_moved"])
def test_the_semantic_check_catches_faults_by_itself(fault):
    """The check written from the step's semantics, with nothing of the
    frozen copy: a sound frame reads rounding and moves no quiet body; a
    step that returns the state unchanged, leaves gravity out, drops a
    free body's spin or moves an asleep body reads far above it."""
    import numpy as np
    from reference import semantics
    desc, pre, host, vel = falling_frame(60, 5, 0 if fault != "quiet_moved"
                                          else 1)
    if fault == "unchanged":
        host = np.concatenate([pre["pos"], pre["orn"]], 1)
        vel = (pre["linvel"], pre["angvel"])
    elif fault == "no_gravity":
        host = host.copy()
        host[:, :3] = pre["pos"] + pre["linvel"] / 60
        vel = (pre["linvel"], vel[1])
    elif fault == "spin_dropped":
        vel = (vel[0], np.zeros_like(vel[1]))
    elif fault == "quiet_moved":
        host = host.copy()
        host[-1, 1] += 0.5
    out = semantics.check(desc, (0, -9.8, 0), 1 / 60,
                          [(pre, host, vel)])
    free_gap = max(out[k] for k in semantics.FREE_GAPS)
    if fault is None:
        assert out["free_bodies"] > 5 and free_gap < 1e-5
        assert out["quiet_bodies_moved"] == 0
    elif fault == "quiet_moved":
        assert out["quiet_bodies"] == 60 and out["quiet_bodies_moved"] == 1
    else:
        assert free_gap > 1e-3


@pytest.mark.parametrize("fault", [None, "moved", "heavier", "inertia"])
def test_the_start_is_judged_against_the_description(fault):
    """The program's built world, on the CPU, holds every body as the
    scene description drew it; one body moved, made heavier, or given
    another inertia is a body that differs."""
    import edyn_tpu_torch as et
    from harness import scene
    from reference import semantics
    desc = scene.mixed_pile(40, 9)
    b, _ = scene.build(et, desc)
    w = et.make_world(b, et.Settings(), device="cpu")
    built = {f: getattr(w.state, f).numpy().copy()
             for f in semantics.START_FIELDS}
    k = len(desc["planes"]) + 6          # a box (kind 1)
    if fault == "moved":
        built["pos"][k, 0] += 1e-3
    elif fault == "heavier":
        built["mass_inv"][k] *= 0.5
    elif fault == "inertia":
        built["inertia_inv"][k, 2, 2] *= 1.01
    out = semantics.start(desc, (0, -9.8, 0), built)
    assert out["start_bodies_differ"] == (0 if fault is None else 1)


@pytest.mark.parametrize("fault", [None, "no_gravity", "torn", "control",
                                   "quiet_moved"])
def test_the_semantic_check_judges_joints(fault):
    """Jointed chains falling as built, every body stepped ballistically
    (joints at rest do nothing in free fall): each chain is one free
    group, none of its bodies a free body, its centre of mass on
    rounding's terms and its pivots together. A step that leaves gravity
    out, a body torn off its joints, or the control (the expectation in
    bfloat16) read above the jointed limits; a joint inside an asleep
    group keeps the group quiet, and a body of it that moves is caught."""
    import numpy as np
    from reference import semantics
    chains = _chains()
    desc = chains.describe(11, n_chains=4)
    s, n = len(desc["planes"]), len(desc["pos"])
    pos = np.zeros((s + n, 3))
    pos[s:] = desc["pos"]
    orn = np.zeros((s + n, 4))
    orn[:, 3] = 1
    orn[s:] = desc["orn"]
    asleep = np.zeros(s + n, bool)
    if fault == "quiet_moved":
        asleep[s:] = True
    pre = dict(pos=pos.astype(np.float32), orn=orn.astype(np.float32),
               linvel=np.zeros((s + n, 3), np.float32),
               angvel=np.zeros((s + n, 3), np.float32), asleep=asleep,
               sleep_timer=np.zeros(s + n, np.float32))
    x, q, v, w = semantics.ballistic(pre["pos"], pre["orn"], pre["linvel"],
                                     pre["angvel"], (0, -9.8, 0), 1 / 60,
                                     np.float32)
    if fault == "quiet_moved":
        x, q, v, w = pre["pos"].copy(), pre["orn"], v * 0, w
        x[s + 7, 0] += 1e-3
    elif fault == "no_gravity":
        v = pre["linvel"]
        x = pre["pos"].copy()
    elif fault == "torn":
        x[s + 2] += (0.0, 0.5, 0.0)
    host = np.concatenate([x, q], 1)
    out = semantics.check(desc, (0, -9.8, 0), 1 / 60, [(pre, host, (v, w))],
                          "bfloat16" if fault == "control" else np.float64)
    limits = JOINT_LIMITS
    over = {k for k in limits if out[k] > limits[k]}
    assert out["free_bodies"] == 0
    if fault == "quiet_moved":
        assert out["free_groups"] == 0 and out["quiet_bodies"] == n
        assert out["quiet_bodies_moved"] == 1 and out["free_bodies_absent"]
        return
    assert out["free_groups"] == 4
    if fault is None:
        assert not over and out["joint_pivot_gap_m"] < 1e-6
    elif fault == "torn":
        assert over == {"free_group_pos_gap_m", "joint_pivot_gap_m"}
    else:
        assert over >= {"free_group_pos_gap_m", "free_group_linvel_gap_mps"}
