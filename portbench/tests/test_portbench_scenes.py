"""The scenes found by name (``harness/scene.py``, ``scenes/<kind>.py``):
the pile's description is the one the benchmark drew before, leaf for
leaf, and the independent check judges it exactly as before."""
from __future__ import annotations

import hashlib

import numpy as np
import pytest

from conftest import falling_frame

# sha256 (first 16 hex digits) of each leaf of the pile's description,
# taken from the scene module before scenes were found by name
# (``harness/scene.py``'s ``mixed_pile``): n_bodies -> planes, kind,
# polyhedra; (n_bodies, seed) -> pos, orn
SAME_FOR_EVERY_SEED = {
    65531: ("8cf744b9cf2c8361", "6990fd6a4baa121e",
            "3cbc87c7681f34db"),
    10000: ("8a55d3edb38a4841", "2f74fee32d0b67de",
            "3cbc87c7681f34db"),
    125: ("71368592275535df", "d078bc87e4b90837",
            "3cbc87c7681f34db"),
}
BY_SEED = {
    (65531, 0): ("22ae083d0a00efed", "738a530e48ddd41b"),
    (65531, 1): ("19d7893bbc1f893a", "185d57daf6ee72d6"),
    (65531, 41): ("2d9eafa62feb8d64", "5fb0bc033e7c7222"),
    (65531, 2147483677): ("d5cc2e3c239ec5cb", "3cb1a3c2c74993b5"),
    (65531, 4294967303): ("1540f36ccd1862f1", "552548c11448ad14"),
    (65531, 1099511627899): ("2ea47b89310b9677", "41524e7e5f0ff66d"),
    (10000, 0): ("a5f779d96b8f1927", "5ea11b03f7b8b11f"),
    (10000, 1): ("49bc2b50c037842f", "457ff6a466709f65"),
    (10000, 41): ("9bf9ab0e8fc89dc8", "69a3f5089c5fd37e"),
    (10000, 2147483677): ("a26e29a1f4a3c6d7", "52f65ceab57a726c"),
    (10000, 4294967303): ("c45c015d92243275", "1b559df2e3a94381"),
    (10000, 1099511627899): ("71f6b99ba4525832", "998161d3384ded17"),
    (125, 0): ("7ce0de6787e1c8be", "bf30e94b493a0ca2"),
    (125, 1): ("d1642c5ed6ec1cc2", "e8e5f2480f790ca9"),
    (125, 41): ("a09cdff5a17599f6", "29732e458a0522f0"),
    (125, 2147483677): ("cfe47a785dbb2c08", "94e89a9831ec4513"),
    (125, 4294967303): ("b70f377615b9b6d1", "fe80b510d6d5908a"),
    (125, 1099511627899): ("b2329e05653c6a26", "83c3bde5e04cf7be"),
}

# ``semantics.check``'s numbers on ``falling_frame(n, seed, every, 1e-3)``,
# taken from the check before it read radii, masses and joints from the
# description: (n, seed, every, dtype) -> the numbers of ``JUDGED``
JUDGED = ("free_pos_gap_m", "free_orn_gap", "free_linvel_gap_mps",
          "free_angvel_gap_radps", "quiet_bodies_moved", "quiet_orn_gap",
          "free_bodies_absent", "free_bodies", "quiet_bodies")
BEFORE = {
    (60, 5, 0, "float64"): (
        9.324815586353452e-09, 4.1375440074098435e-08, 8.265177431354687e-08,
        0, 0, 0, 0, 7, 0),
    (60, 5, 0, "float32"): (
        9.324815586353452e-09, 4.1375440074098435e-08, 8.265177431354687e-08,
        0, 0, 0, 0, 7, 0),
    (60, 5, 0, "bfloat16"): (
        0.015442362043592617, 0.003608486049444859, 0.007083333333333108,
        0.002901792526245117, 0, 0, 0, 7, 0),
    (60, 5, 1, "float64"): (
        0, 0, 0,
        0, 1, 0, 1, 0, 60),
    (60, 5, 1, "float32"): (
        0, 0, 0,
        0, 0, 0, 1, 0, 60),
    (60, 5, 1, "bfloat16"): (
        0, 0, 0,
        0, 60, 0.0019178390502929688, 1, 0, 60),
    (60, 5, 3, "float64"): (
        9.324815586353452e-09, 7.427373271973181e-09, 8.265177431354687e-08,
        0, 0, 0, 0, 1, 0),
    (60, 5, 3, "float32"): (
        9.324815586353452e-09, 7.427373271973181e-09, 8.265177431354687e-08,
        0, 0, 0, 0, 1, 0),
    (60, 5, 3, "bfloat16"): (
        0.0036769006517198832, 0.0002569221968296287, 0.007083333333333108,
        0.0001830458641052246, 0, 0, 0, 1, 0),
    (125, 2147483651, 2, "float64"): (
        9.324815586353452e-09, 1.02643625266019e-08, 8.265177431354687e-08,
        0, 0, 0, 0, 1, 5),
    (125, 2147483651, 2, "float32"): (
        9.324815586353452e-09, 1.02643625266019e-08, 8.265177431354687e-08,
        0, 0, 0, 0, 1, 5),
    (125, 2147483651, 2, "bfloat16"): (
        0.00946093538072379, 0.0014749570016519553, 0.007083333333333108,
        0.0013985633850097656, 5, 0.0018790960311889648, 0, 1, 5),
}


def leaf_hash(v) -> str:
    if isinstance(v, np.ndarray):
        b = f"{v.dtype.str}{v.shape}".encode() \
            + np.ascontiguousarray(v).tobytes()
    else:
        b = repr(v).encode()
    return hashlib.sha256(b).hexdigest()[:16]


@pytest.mark.parametrize("n, seed", sorted(BY_SEED))
def test_the_pile_is_described_as_before(n, seed):
    """At the configurations' sizes and the warm-up's, on six seeds (the
    driver's are large), every leaf the pile's description had is the
    same, to the byte."""
    from harness import scene
    desc = scene.describe(dict(kind="mixed_pile", n_bodies=n), seed)
    got = {k: leaf_hash(desc[k])
           for k in ("planes", "kind", "polyhedra", "pos", "orn")}
    planes, kind, polyhedra = SAME_FOR_EVERY_SEED[n]
    pos, orn = BY_SEED[(n, seed)]
    assert got == dict(planes=planes, kind=kind, polyhedra=polyhedra,
                       pos=pos, orn=orn)


def test_the_pile_gives_what_every_scene_gives():
    """The general keys of a description hold what the check assumed of
    the pile before: each kind's bounding radius, unit mass, the
    material, a solid's inverse inertia for the spheres and boxes, no
    joints; and ``small`` sizes a pile by its bodies."""
    from harness import scene, spec
    desc = scene.mixed_pile(40, 3)
    tet = np.array([[0.15, 0.15, 0.15], [0.15, -0.15, -0.15],
                    [-0.15, 0.15, -0.15], [-0.15, -0.15, 0.15]], np.float32)
    radius = (0.15, float(np.linalg.norm((0.15, 0.12, 0.18))), 0.1 + 0.15,
              float(np.hypot(0.12, 0.15)),
              float(np.linalg.norm(tet, axis=1).max()))
    assert desc["scene"] == "mixed_pile" and desc["joints"] == []
    assert desc["radius"].tolist() == [radius[k] for k in desc["kind"]]
    assert desc["mass"].tolist() == [1.0] * 40
    assert {k: set(v.tolist()) for k, v in desc["material"].items()} == dict(
        friction={0.5}, restitution={0.2}, roll_friction={0.005})
    h2 = np.square(2 * np.array([0.15, 0.12, 0.18]))
    inv = desc["inertia_inv"]
    assert np.array_equal(inv[desc["kind"] == 0],
                          np.full(((desc["kind"] == 0).sum(), 3),
                                  1 / (0.4 * 0.15 ** 2)))
    assert np.array_equal(inv[desc["kind"] == 1][0], 12 / (h2.sum() - h2))
    assert np.isnan(inv[desc["kind"] >= 2]).all()
    assert scene.small(dict(kind="mixed_pile", n_bodies=10_000), 125) == \
        dict(kind="mixed_pile", n_bodies=125)
    assert spec.scene_file("mixed_pile").exists()
    with pytest.raises(FileNotFoundError):
        spec.scene_module("no_such_scene")


@pytest.mark.parametrize("n, seed, every, dtype", sorted(BEFORE))
def test_the_pile_is_judged_as_before(n, seed, every, dtype):
    """Without joints every number of the independent check is the one it
    read before, to the bit: free bodies falling, a body read back a
    millimetre off, all asleep or every second or third asleep, in
    float64, the witness's float32 and the control's bfloat16."""
    from reference import semantics
    desc, pre, host, vel = falling_frame(n, seed, every, 1e-3)
    out = semantics.check(desc, (0, -9.8, 0), 1 / 60, [(pre, host, vel)],
                          np.float64 if dtype == "float64" else
                          np.float32 if dtype == "float32" else dtype)
    assert tuple(out[k] for k in JUDGED) == BEFORE[(n, seed, every, dtype)]
    assert out["free_groups"] == 0 and out["joint_pivot_gap_m"] == 0.0
