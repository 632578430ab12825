"""Engine constants and runtime settings (PyTorch port).

Same tiers and values as ``edyn_tpu/config.py``: hard constants
(reference: include/edyn/config/constants.hpp) and the frozen runtime
``Settings`` (reference: include/edyn/context/settings.hpp:21-58).

The scalar type is ``scalar_dtype()``: float64 while PyTorch's default
dtype is float64 (``torch.set_default_dtype(torch.float64)`` before a
world is built), float32 otherwise, the counterpart of the JAX package's
``jax_enable_x64`` switch and of the reference's EDYN_DOUBLE_PRECISION
(include/edyn/math/scalar.hpp:9-15). Construction and every host-to-device
cast go through it; inside the step every float follows the state's own
dtype.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# --- hard constants (reference: include/edyn/config/constants.hpp) ---
MAX_CONTACTS = 4
COLLISION_THRESHOLD = 0.01
CONTACT_BREAKING_THRESHOLD = 0.02
CONTACT_MERGING_THRESHOLD = 0.01
CONTACT_CACHING_THRESHOLD = 0.04
ISLAND_LINEAR_SLEEP_THRESHOLD = 0.005
ISLAND_ANGULAR_SLEEP_THRESHOLD = math.pi / 48.0
ISLAND_TIME_TO_SLEEP = 2.0
SUPPORT_FEATURE_TOLERANCE = 0.005
CONTACT_POSITION_CORRECTION_RATE = 0.2
CONTACT_POSITION_SOLVER_MIN_ERROR = -0.005
CONVEX_MESH_RELEVANT_DIRECTION_TOLERANCE = 0.0006
# Pair admission margin: a pair occupies a manifold slot only while the
# bodies' swept tight AABBs, each inflated by this margin, overlap (the
# combined gap equals the reference's manifold-destruction threshold,
# broadphase.hpp m_separation_threshold = 1.3 * contact_breaking).
PAIR_SEPARATION_MARGIN = 0.65 * CONTACT_BREAKING_THRESHOLD

GRAVITY_EARTH = (0.0, -9.8, 0.0)  # reference: include/edyn/math/constants.hpp
LARGE_SCALAR = 1e9  # stiffness above this => rigid contact

def scalar_dtype() -> torch.dtype:
    """float64 when it is PyTorch's default dtype, else float32."""
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


def numpy_dtype(dtype: torch.dtype):
    """The numpy scalar type of a torch float dtype."""
    return np.float64 if dtype == torch.float64 else np.float32


@dataclasses.dataclass(frozen=True)
class Settings:
    """Runtime settings (reference: include/edyn/context/settings.hpp:21-58).
    Field for field the same as ``edyn_tpu.Settings``, plus
    ``cone_max_violation``, ``mesh_triangle_cull`` and
    ``pool_convex_rows`` (``PORT_ONLY``)."""
    fixed_dt: float = 1.0 / 60.0
    gravity: tuple = GRAVITY_EARTH
    max_steps_per_update: int = 10
    num_solver_velocity_iterations: int = 8
    num_solver_position_iterations: int = 3
    num_restitution_iterations: int = 8
    num_individual_restitution_iterations: int = 3
    paused: bool = False
    # batched-impulse relaxation: impulses into shared bodies are scaled by
    # the body's constraint degree (mass splitting)
    mass_splitting: bool = True
    enable_sleeping: bool = True
    # speculative contact distance (reference: collision_threshold)
    collision_threshold: float = COLLISION_THRESHOLD
    # The cone row's violation (ey^2 + ez^2 - 1, from the tangents of B's
    # axis in A's frame) grows without bound as B's axis nears 90 degrees
    # from A's, and the row then asks for ~1e7 rad/s (ROADMAP R8). None
    # keeps that row, the JAX package's. A number caps the violation there:
    # a departure from the reference, whose results are not the JAX
    # package's once a cone row reaches the cap.
    cone_max_violation: float | None = None
    # The MESH bucket runs the SAT on all 64 candidate triangles of the
    # body's grid cell, and a triangle beside the body can give a contact
    # point metres from it with a real depth (ROADMAP R10). False keeps
    # that, the JAX package's bucket. True keeps only the candidate
    # triangles whose AABB overlaps the body's AABB inflated by the
    # collision threshold, as the C++ reference's static triangle tree
    # does: a departure from the JAX package.
    mesh_triangle_cull: bool = False
    # A network client spawns the bodies a server announces
    # (``EntityEntered``) from their component pools. The JAX client copies
    # the columns but leaves the slot's convex-table row as it was, so a
    # box or cylinder entered that way collides as whatever shape the slot
    # held before, usually a point (ROADMAP R13). False keeps that, the JAX
    # package's client. True writes the row from the entered shape (a
    # polyhedron's from the client's own polyhedron table at the entered
    # ``shape_index``): a departure from the JAX package.
    pool_convex_rows: bool = False

    PORT_ONLY = ("cone_max_violation", "mesh_triangle_cull",
                 "pool_convex_rows")

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)
