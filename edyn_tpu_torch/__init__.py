"""edyn_tpu_torch — the PyTorch and CUDA port of edyn_tpu for NVIDIA Hopper.

Same public surface and subpackage layout as ``edyn_tpu``: a world is a
structure of tensors stepped by plain PyTorch code around hand-written CUDA
kernels (``csrc/``), on the device the caller picks (``cuda`` by default).
"""
from .config import Settings
from .core.builder import Material, RigidBodyDef, WorldBuilder
from .core.state import KIND_DYNAMIC, KIND_KINEMATIC, KIND_STATIC, WorldState
from .core.world import World, derive_meta, make_world
from .shapes.params import (
    BoxShape, CapsuleShape, CompoundShape, CylinderShape, MeshShape,
    PagedMeshShape, PlaneShape, PolyhedronShape, SphereShape,
)
from .constraints.api import (
    dof, make_cone_constraint, make_cvjoint_constraint, make_distance_constraint,
    make_generic_constraint, make_gravity_constraint, make_hinge_constraint,
    make_null_constraint, make_point_constraint, make_soft_distance_constraint,
)
from .constraints.joints import JointType
from .shapes.volume import mesh_centroid, shape_volume
from .simulation.stepper import SceneMeta, physics_step

__all__ = [
    "Settings", "Material", "RigidBodyDef", "WorldBuilder", "WorldState",
    "World", "make_world", "derive_meta", "SceneMeta", "physics_step",
    "KIND_DYNAMIC", "KIND_KINEMATIC", "KIND_STATIC",
    "SphereShape", "BoxShape", "CapsuleShape", "CylinderShape", "PlaneShape",
    "PolyhedronShape", "CompoundShape", "MeshShape", "PagedMeshShape",
    "make_distance_constraint", "make_soft_distance_constraint",
    "make_point_constraint", "make_hinge_constraint", "make_cone_constraint",
    "make_generic_constraint", "make_cvjoint_constraint", "dof",
    "make_gravity_constraint", "make_null_constraint", "JointType",
    "shape_volume", "mesh_centroid",
]
