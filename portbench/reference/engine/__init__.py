"""The benchmark's step-by-step reference: a frozen copy of the PyTorch
modules of ``edyn_tpu_torch`` that build a world and step it (the builder,
the state, the broadphase, the narrowphase, the manifolds, the contact
rows, the restitution pre-pass, the velocity and position iterations,
integration, islands and sleep), taken when the benchmark was written and
cut down to the plain step of the benchmark's scenes (convex shapes and
planes; the point, cone and hinge joints, whose factories, rows, solve and
position correction were copied later; one shard on one device):

- every kernel of the step is its plain PyTorch version, on the CPU and
  on the card alike (K4's ``collide_support_plain`` for the UNIFIED bucket
  on the card, ``support_sat`` on the CPU, as the program does; the plain
  K1, K3a, K3b and K2), and no hand-written kernel is built or launched;
- the solve phase keeps the unfused path (gather, plain iteration,
  ``index_sum``) that the program's fused kernels replace on the card;
- the other joint types, meshes, compounds, spawning and the runtime API
  are left out.

It imports nothing of the program: a later change to the program does not
change it. Being a copy of the program's own plain layers, it holds the
program's kernels to their plain versions and the whole step to the step
as it was when the benchmark was written; ``reference.semantics`` is the
check written from the step's semantics instead. Its sums on the card keep
``index_sum``'s order.
"""
from .config import Settings
from .constraints.api import (
    make_cone_constraint, make_hinge_constraint, make_point_constraint,
)
from .core.builder import Material, RigidBodyDef, WorldBuilder
from .core.state import KIND_DYNAMIC, KIND_KINEMATIC, KIND_STATIC, WorldState
from .core.world import World, derive_meta, make_world
from .shapes.params import (
    BoxShape, CapsuleShape, CylinderShape, PlaneShape, PolyhedronShape,
    SphereShape,
)
from .simulation.stepper import SceneMeta, physics_step

__all__ = [
    "Settings", "Material", "RigidBodyDef", "WorldBuilder", "WorldState",
    "World", "make_world", "derive_meta", "SceneMeta", "physics_step",
    "KIND_DYNAMIC", "KIND_KINEMATIC", "KIND_STATIC",
    "SphereShape", "BoxShape", "CapsuleShape", "CylinderShape", "PlaneShape",
    "PolyhedronShape", "make_point_constraint", "make_cone_constraint",
    "make_hinge_constraint",
]
