"""The benchmark's frozen scenes, found by name: a configuration's
``scene.kind`` names the file ``scenes/<kind>.py``, whose

- ``describe(seed, **params)`` draws the scene from the seed as plain
  data (the description);
- ``build(pkg, desc)`` builds it through any package with the engine's
  builder and joint API (``WorldBuilder``, ``make_rigidbody``,
  ``make_point_constraint``, ``make_cone_constraint``,
  ``make_hinge_constraint``), the program and the reference alike, and
  returns (builder, dynamic ids);
- ``small(params, n_bodies)`` gives the parameters of a small world of the
  same scene, about ``n_bodies`` bodies (a mix's warm-up).

Every description holds ``scene`` (its kind), ``planes`` [(normal,
constant)], and per body, in the order ``build`` adds them after the
planes: ``pos`` [n,3] and ``orn`` [n,4] (xyzw) as built, ``radius`` (the
bounding radius about the centre of mass), ``mass`` (0: static),
``inertia_inv`` [n,3] (the diagonal of the inverse inertia in the body's
frame; NaN where the start check does not judge it), ``material``
({"friction", "restitution", "roll_friction"}: [n] each); and ``joints``,
one dict a joint: ``type`` ("point", "cone" or "hinge"), the bodies ``a``
and ``b`` (indices into the bodies), ``pivot_a`` and ``pivot_b`` (each in
its body's frame, relative to the centre of mass), and what else the
scene's ``build`` needs. ``reference.semantics`` reads nothing else.
"""
from __future__ import annotations

import numpy as np

from . import spec


def rng_for(seed: int) -> np.random.Generator:
    """A generator for any whole-number seed, negative or past 64 bits."""
    return np.random.default_rng(int(seed) % (1 << 64))


def params(scene: dict) -> dict:
    """A configuration's ``scene`` entry without its ``kind``."""
    return {k: v for k, v in scene.items() if k != "kind"}


def describe(scene: dict, seed: int, bench_dir=spec.BENCH_DIR) -> dict:
    """The description of a configuration's ``scene`` entry."""
    return spec.scene_module(scene["kind"], bench_dir).describe(
        seed=seed, **params(scene))


def build(pkg, desc: dict, bench_dir=spec.BENCH_DIR):
    """(builder, dynamic ids) of a description, by its scene's ``build``."""
    return spec.scene_module(desc["scene"], bench_dir).build(pkg, desc)


def small(scene: dict, n_bodies: int, bench_dir=spec.BENCH_DIR) -> dict:
    """A configuration's ``scene`` entry for a small world of the same
    scene, about ``n_bodies`` bodies."""
    mod = spec.scene_module(scene["kind"], bench_dir)
    return dict(mod.small(params(scene), n_bodies), kind=scene["kind"])


def mixed_pile(n_bodies: int, seed: int, **kw) -> dict:
    """The pile's description (``scenes/mixed_pile.py``) by its sizes."""
    return describe(dict(kind="mixed_pile", n_bodies=n_bodies, **kw), seed)
