"""Whole-step parity of the PyTorch port with the JAX package on a small
``rich_scene`` (``n_bodies=48, n_chains=2, chain_links=4``, the size of
``tests/test_sharding.py``): a trimesh terrain, four wall planes, a mixed
pile and two hinge chains, with four compounds of ``examples/vehicle.py``'s
chassis shape added: one dropped onto the terrain, one onto it (compound on
compound), one against a wall (compound on plane and mesh) and one onto a
hinge chain's capsules (compound on convex). Every bucket class of the step
makes contacts within the checked steps: UNIFIED, BOXBOX, MESH and the four
compound classes (the pile reaches no wall, so PLANE has pairs but no
points).

Method and tolerances are ``test_torch_step.py``'s, but the start states
are the port's own trajectory on the CPU, carried into JAX states (no
compile of the JAX package's jitted step, minutes on a cold compilation
cache): from every fourth of the first 40, both packages take one step
(the JAX package op by op) and pos, orn and linvel must agree at the
whole-step tolerances, a body outside them passing only within twice the
reference's own 1-ulp sensitivity
(``check_step``). Mesh contacts pick among near-equal triangle features,
so this rule matters here as much as in the pile. The port runs on the
CPU, one thread.
"""
import importlib

import numpy as np
import pytest

from edyn_tpu.collision import narrowphase as jnph

from test_torch_step import Trajectory, eager_cache, one_thread  # noqa: F401

CHASSIS = ((0.9, 0.18, 0.5), (0.4, 0.14, 0.45), (-0.1, 0.3, 0))
# (position, what it lands on); the terrain spans +-8 m, the walls stand at
# x, z = +-8, the pile is within 1.2 m of the origin, the first chain's
# links hang from (-3, 6.2, 4) along +x
DROPS = (((5.0, 0.6, -5.0), "terrain"), ((5.0, 1.4, -5.0), "compound"),
         ((7.095, 0.6, 5.0), "wall"), ((-1.75, 6.6, 4.0), "chain"))
# every fourth of the first 40 steps: the pile lands from step ~31 on
CHECKED = range(3, 40, 4)


def terrain48(pkg):
    """``rich_scene(48, n_chains=2, chain_links=4)`` and the chassis
    compounds, through a package's public names."""
    scenes = importlib.import_module(pkg.__name__ + ".utils.scenes")
    b, _ = scenes.rich_scene(n_bodies=48, n_chains=2, chain_links=4)
    big, top, at = CHASSIS
    shape = pkg.CompoundShape(children=[
        (pkg.BoxShape(big), (0, 0, 0), (0, 0, 0, 1)),
        (pkg.BoxShape(top), at, (0, 0, 0, 1))])
    for pos, _ in DROPS:
        b.make_rigidbody(pkg.RigidBodyDef(
            mass=4.0, shape=shape, position=pos,
            material=pkg.Material(friction=0.4)))
    return b


@pytest.fixture(scope="module")
def terrain(eager_cache):  # noqa: F811
    return Trajectory(max(CHECKED), terrain48, source="port")


def test_every_bucket_class_makes_contacts(terrain):
    """At some checked step, each bucket class has a pair with points."""
    seen = set()
    for i in CHECKED:
        st = terrain.states[i]
        man = st.contacts
        types = np.asarray(st.shape_type)
        cls, _ = jnph.classify(types[np.asarray(man.body_a)],
                               types[np.asarray(man.body_b)])
        live = np.asarray(man.valid) & np.asarray(man.point_valid).any(1)
        seen |= set(np.asarray(cls)[live].tolist())
    assert seen >= {jnph.B_UNIFIED, jnph.B_BOXBOX, jnph.B_MESH,
                    jnph.B_COMP_CONVEX, jnph.B_COMP_PLANE, jnph.B_COMP_COMP,
                    jnph.B_COMP_MESH}, sorted(seen)
    assert terrain.tw.meta.types_present == terrain.jw.meta.types_present


@pytest.mark.parametrize("step", CHECKED)
def test_terrain_step_parity(terrain, step):
    terrain.check_step(step)
