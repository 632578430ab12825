"""World: the user-facing handle around the state and the step (counterpart
of ``edyn_tpu/core/world.py``; reference: include/edyn/edyn.hpp:66-150 and
the fixed-timestep accumulator, stepper_sequential.cpp:45-65)."""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import ISLAND_TIME_TO_SLEEP, Settings, numpy_dtype
from ..constraints.joints import JointType, types_present
from ..simulation.stepper import SceneMeta, physics_step
from .builder import WorldBuilder
from .device import resolve_device
from .spawn import set_rows
from .state import (
    KIND_DYNAMIC, KIND_STATIC, WorldState, grow_contact_table,
)


def _pairs_for(n_bodies: int) -> int:
    # 16 pairs per body covers the settled mixed pile's measured demand
    # (14.2/body) with headroom; grow-on-overflow is the backstop
    return max(256, min(16 * n_bodies, 1 << 19))


def derive_meta(state: WorldState, max_pairs: Optional[int] = None,
                **kw) -> SceneMeta:
    """The static scene facts of a freshly built state (host read)."""
    valid = state.valid.cpu().numpy()
    stypes = state.shape_type.cpu().numpy()
    present = frozenset(int(t) for t in np.unique(stypes[valid]))
    if max_pairs is None:
        max_pairs = _pairs_for(int(valid.sum()))
    max_pairs = min(max_pairs, state.contacts.key.shape[0])
    kw.setdefault("bucket_cap", max(512, max_pairs // 2))
    kw.setdefault("max_rows", max_pairs)
    has_sr = bool((state.spin_friction.cpu().numpy()[valid] > 0).any()
                  or (state.roll_friction.cpu().numpy()[valid] > 0).any()
                  or (state.mix_table.vals.cpu().numpy()[:, 2:4] > 0).any())
    kw.setdefault("has_spin_roll", has_sr)
    kw.setdefault("has_joints", bool(state.joints.valid.any()))
    kw.setdefault("joint_types", types_present(state.joints))
    return SceneMeta(types_present=present, max_pairs=max_pairs, **kw)


class World:
    """Owns the state and drives the step."""

    GROW_FACTOR = 1.3

    def __init__(self, state: WorldState, settings: Settings = Settings(),
                 meta: Optional[SceneMeta] = None):
        self.state = state
        self.settings = settings
        self.meta = meta or derive_meta(state)
        self._accumulator = 0.0
        self._last_time: Optional[float] = None
        # grow-on-overflow: a step that dropped pairs, candidates or rows
        # bumps the capacity before the next step. The JAX package checks
        # after each step_n batch and every 16th step() only, because
        # reading its counters stalls the device; the port's stepper syncs
        # every step anyway. A 10k-body pile that lands needs ~19 pairs a
        # body, more than the 16 of _pairs_for: checked once per batch, it
        # dropped floor contacts for tens of steps and bodies fell through
        # the floor.
        self.auto_grow = True
        # replication policies of the user components (make_world copies
        # the builder's; replication.exporter.policy_from_world reads them)
        self.user_component_policies: dict = {}

    @property
    def device(self):
        return self.state.device

    # -- stepping -------------------------------------------------------
    def step(self, n: int = 1):
        """Advance n fixed-dt steps."""
        for _ in range(n):
            self.state = physics_step(self.state, self.settings, self.meta)
            if self.auto_grow:
                self._maybe_grow()
        return self

    def step_n(self, n: int):
        """Advance n fixed-dt steps (the JAX package's single-program batch;
        the port steps from the host either way, so this is ``step``)."""
        return self.step(n)

    def _maybe_grow(self):
        """Any nonzero drop counter of the last step bumps the matching
        capacity by GROW_FACTOR; live state is padded, never rebuilt. Window
        alarms (overflow[3]) do not trigger growth."""
        ovf = self.state.overflow.cpu().numpy()
        if ovf[[0, 1, 2, 4]].max() <= 0:
            return False
        meta = self.meta
        changes = {}
        if ovf[0] > 0 or ovf[4] > 0:
            new_pairs = -(-int(meta.max_pairs * self.GROW_FACTOR) // 128) * 128
            changes["max_pairs"] = new_pairs
            if meta.max_rows is not None:
                changes["max_rows"] = max(meta.max_rows,
                                          min(new_pairs, meta.max_rows * 2))
            if meta.bucket_cap is not None:
                changes["bucket_cap"] = max(meta.bucket_cap, new_pairs // 2)
            st = self.state
            # the carried pair list is the truncated one: recompute it
            self.state = dataclasses.replace(
                st,
                bp_carry_ok=torch.zeros_like(st.bp_carry_ok),
                contacts=grow_contact_table(st.contacts, new_pairs),
                edge_pointed=torch.cat([
                    st.edge_pointed,
                    torch.zeros((new_pairs - meta.max_pairs,),
                                dtype=torch.bool, device=st.device)]))
        if ovf[1] > 0 and meta.bucket_cap is not None:
            changes["bucket_cap"] = -(-int(max(
                changes.get("bucket_cap", meta.bucket_cap),
                meta.bucket_cap * self.GROW_FACTOR)) // 128) * 128
        if ovf[2] > 0 and meta.max_rows is not None:
            changes["max_rows"] = -(-int(max(
                changes.get("max_rows", meta.max_rows),
                meta.max_rows * self.GROW_FACTOR)) // 128) * 128
        if not changes:
            return False
        self.meta = dataclasses.replace(meta, **changes)
        self.state = dataclasses.replace(
            self.state, overflow=torch.zeros_like(self.state.overflow))
        return True

    def update(self, elapsed: Optional[float] = None):
        """Variable-rate update with the fixed-dt accumulator and the
        max-steps cap."""
        now = time.perf_counter()
        if elapsed is None:
            elapsed = 0.0 if self._last_time is None else now - self._last_time
        self._last_time = now
        if self.settings.paused:
            return self
        self._accumulator += elapsed
        num = int(self._accumulator // self.settings.fixed_dt)
        num = min(num, self.settings.max_steps_per_update)
        self._accumulator -= num * self.settings.fixed_dt
        return self.step(num)

    def set_settings(self, **kw):
        self.settings = self.settings.replace(**kw)
        return self

    # -- accessors ------------------------------------------------------
    def position(self, i):
        return self.state.pos[i].cpu().numpy()

    def orientation(self, i):
        return self.state.orn[i].cpu().numpy()

    def linvel(self, i):
        return self.state.linvel[i].cpu().numpy()

    def angvel(self, i):
        return self.state.angvel[i].cpu().numpy()

    def apply_torque_impulse(self, i, torque_impulse):
        """Add the world-space inverse inertia times ``torque_impulse`` to
        body i's angular velocity and wake it (reference:
        rigidbody_apply_torque_impulse)."""
        st = self.state
        t = self._host(torque_impulse)
        angvel = st.angvel.clone()
        angvel[i] += st.inertia_world_inv()[i] @ t
        asleep = st.asleep.clone()
        asleep[i] = False
        timer = st.sleep_timer.clone()
        timer[i] = 0.0
        self.state = dataclasses.replace(st, angvel=angvel, asleep=asleep,
                                         sleep_timer=timer)
        return self

    def block_until_ready(self):
        """Wait for the device's queued work (the JAX package's
        ``jax.block_until_ready`` on the state)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def _host(self, x):
        """A host value as a tensor at the world's scalar dtype."""
        return torch.as_tensor(
            np.asarray(x, np.float64).astype(numpy_dtype(self.state.dtype)),
            device=self.device)

    def set_center_of_mass(self, i, com):
        """Move the body's COM keeping the shape's world pose: the stored
        position moves to the new world COM and linvel takes the w x dr
        term; the inertia is kept (reference: set_center_of_mass ->
        apply_center_of_mass, src/edyn/util/rigidbody.cpp:364-543)."""
        from ..math import quat, vec
        st = self.state
        com = self._host(com)
        orn = st.orn[i]
        origin = st.pos[i] - quat.rotate(orn, st.com[i])
        com_w = origin + quat.rotate(orn, com)
        dlin = vec.cross(st.angvel[i], com_w - st.pos[i])
        self.state = set_rows(st, i, pos=com_w, com=com,
                              linvel=st.linvel[i] + dlin, asleep=False,
                              sleep_timer=0.0)
        return self

    def set_roll_direction(self, i, direction):
        """Override the object-space rolling axis (reference:
        comp/roll_direction.hpp; a zero vector rolls isotropically)."""
        self.state = set_rows(self.state, i, roll_axis=self._host(direction))
        return self

    # -- mutators (reference: util/rigidbody.cpp) -----------------------
    def apply_impulse(self, i, impulse, rel_location=(0.0, 0.0, 0.0)):
        """reference: rigidbody_apply_impulse."""
        from ..math import vec
        st = self.state
        imp = self._host(impulse)
        rel = self._host(rel_location)
        Iw = st.inertia_world_inv()[i]
        self.state = set_rows(
            st, i, linvel=st.linvel[i] + st.mass_inv[i] * imp,
            angvel=st.angvel[i] + Iw @ vec.cross(rel, imp), asleep=False,
            sleep_timer=0.0)
        return self

    def set_position(self, i, position, orientation=None):
        """Kinematic or teleport move (reference:
        update_kinematic_position)."""
        kw = {"pos": self._host(position)}
        if orientation is not None:
            kw["orn"] = self._host(orientation)
        self.state = set_rows(self.state, i, **kw)
        # a teleported PLANE keeps its world-slab AABB (no box escape
        # fires), so the pair carry is invalidated here
        self._reset_island_stability()
        return self

    def set_velocity(self, i, linvel=None, angvel=None):
        kw = {"asleep": False, "sleep_timer": 0.0}
        if linvel is not None:
            kw["linvel"] = self._host(linvel)
        if angvel is not None:
            kw["angvel"] = self._host(angvel)
        self.state = set_rows(self.state, i, **kw)
        return self

    def exclude_collision(self, a: int, b: int):
        """Runtime collision exclusion (reference:
        util/exclude_collision.hpp), appended to both bodies' fixed-width
        lists."""
        # host read: the lists are edited on the host, as numpy does
        ex = self.state.exclusions.cpu().numpy().copy()
        for x, y in ((a, b), (b, a)):
            row = ex[x]
            if y in row:
                continue
            slots = np.nonzero(row < 0)[0]
            if not len(slots):
                raise ValueError(f"exclusion list of body {x} full")
            ex[x, int(slots[0])] = y
        self.state = dataclasses.replace(
            self.state, exclusions=torch.as_tensor(ex, device=self.device))
        self._reset_island_stability()  # pair eligibility changed
        return self

    def set_mass(self, i, mass: float):
        """reference: set_rigidbody_mass (rigidbody.cpp:300-305): the mass
        only; the inertia is untouched (``set_inertia``)."""
        if not mass > 0:
            raise ValueError("mass must be positive")
        self.state = set_rows(self.state, i, mass_inv=1.0 / mass)
        return self

    def set_inertia(self, i, inertia):
        """reference: set_rigidbody_inertia (rigidbody.cpp:307-312). Takes
        the local 3x3 inertia tensor or its diagonal [3]."""
        I = np.asarray(inertia, np.float64)
        if I.ndim == 1:
            I = np.diag(I)
        self.state = set_rows(self.state, i,
                              inertia_inv=self._host(np.linalg.inv(I)))
        return self

    def set_friction(self, i, friction: float):
        """reference: set_rigidbody_friction (rigidbody.cpp:314-345).
        Contact rows re-mix body materials every step, so live contacts
        take the new value on the next step."""
        self.state = set_rows(self.state, i, friction=friction)
        return self

    def get_gravity(self, i=None):
        """Body i's gravity, or the world default when i is None
        (reference: get_gravity, util/gravity_util.hpp:15)."""
        if i is None:
            return np.asarray(self.settings.gravity)
        return self.state.gravity[i].cpu().numpy()

    def set_gravity(self, g, i=None):
        """Set body i's gravity, or the world default and every dynamic
        body still on it (reference: set_gravity,
        util/gravity_util.hpp:23)."""
        st = self.state
        g = self._host(g)
        if i is not None:
            self.state = set_rows(st, i, gravity=g)
            return self
        old = self._host(self.settings.gravity)
        on_default = (st.kind == KIND_DYNAMIC) & torch.all(
            st.gravity == old[None, :], dim=-1)
        self.settings = dataclasses.replace(
            self.settings, gravity=tuple(float(x) for x in g.cpu().numpy()))
        self.state = dataclasses.replace(
            st, gravity=torch.where(on_default[:, None], g[None, :],
                                    st.gravity))
        return self

    def set_kind(self, i, kind, mass: float | None = None):
        """Change a body's kind (reference: rigidbody_set_kind); becoming
        dynamic takes a mass and recomputes the inertia from the shape."""
        from ..shapes.inertia import moment_of_inertia
        st = self.state
        kw = {"kind": int(kind), "asleep": False, "sleep_timer": 0.0}
        if kind == KIND_DYNAMIC:
            if mass is None or not mass > 0:
                raise ValueError("becoming dynamic requires a mass")
            # host read: the shape's parameters for its inertia
            stype = int(st.shape_type[i])
            params = st.shape_params[i].cpu().numpy()
            I = np.diag(moment_of_inertia(stype, params, mass))
            kw.update(mass_inv=1.0 / mass,
                      inertia_inv=self._host(np.linalg.inv(I)),
                      gravity=self._host(self.settings.gravity))
        else:
            kw.update(mass_inv=0.0, inertia_inv=0.0, gravity=0.0)
            if kind == KIND_STATIC:
                kw["linvel"] = 0.0
        self.state = set_rows(st, i, **kw)
        # only dynamic bodies connect islands: the graph changed without a
        # pair-list change
        self._reset_island_stability()
        return self

    def set_shape(self, i, shape):
        """Swap a body's simple shape (reference: rigidbody_set_shape): the
        mass is kept, the inertia recomputed, the body's manifolds
        cleared."""
        from ..shapes.inertia import moment_of_inertia
        from ..shapes.params import shape_roll_direction
        from .spawn import update_convex_row
        st = self.state
        stype, params = shape.pack()
        kw = {"shape_type": int(stype), "shape_params": self._host(params),
              # the roll direction follows the shape (rigidbody.cpp:450-466)
              "roll_axis": self._host(shape_roll_direction(int(stype),
                                                          params))}
        # host read: the body's mass
        minv = float(st.mass_inv[i])
        if minv > 0:
            I = np.diag(moment_of_inertia(int(stype), params, 1.0 / minv))
            kw["inertia_inv"] = self._host(np.linalg.inv(I))
        st = set_rows(st, i, **kw)
        # this body's contact points are invalid for the new shape
        # (rigidbody.cpp:488-495)
        man = st.contacts
        hit = ((man.body_a == i) | (man.body_b == i)) & man.valid
        h1, h2 = hit[:, None], hit[:, None, None]
        zero = lambda x, h: torch.where(h, torch.zeros_like(x), x)
        man = dataclasses.replace(
            man, point_valid=man.point_valid & ~h1,
            normal_impulse=zero(man.normal_impulse, h1),
            friction_impulse=zero(man.friction_impulse, h2),
            spin_impulse=zero(man.spin_impulse, h1),
            roll_impulse=zero(man.roll_impulse, h2),
            lifetime=zero(man.lifetime, h1))
        self.state = dataclasses.replace(
            st, contacts=man,
            convex=update_convex_row(st.convex, i, int(stype), params))
        self.meta = dataclasses.replace(
            self.meta, types_present=self.meta.types_present | {int(stype)})
        # points cleared without a pair-list change: the pointed mask moves
        # under the steady-state label skip
        self._reset_island_stability()
        return self

    def spawn(self, def_, poly_index=None) -> int:
        """Create a body in a free slot (reference: make_rigidbody on a
        live registry). Returns its slot."""
        from .spawn import spawn_rigidbody
        self.state, idx = spawn_rigidbody(self.state, def_,
                                          poly_index=poly_index)
        # host read: the new row's shape type
        stype = int(self.state.shape_type[idx])
        if stype not in self.meta.types_present:
            self.meta = dataclasses.replace(
                self.meta, types_present=self.meta.types_present | {stype})
        m = def_.material
        if m is not None and (m.spin_friction > 0 or m.roll_friction > 0) \
                and not self.meta.has_spin_roll:
            self.meta = dataclasses.replace(self.meta, has_spin_roll=True)
        self._reset_island_stability()
        return idx

    def destroy(self, i):
        """reference: clear_rigidbody."""
        from .spawn import destroy_rigidbody
        self.state = destroy_rigidbody(self.state, i)
        self._reset_island_stability()
        return self

    # -- queries and events ---------------------------------------------
    def manifold_between(self, a, b) -> dict | None:
        """The contact manifold of two bodies, or None (reference:
        manifold_exists / get_manifold_entity,
        util/contact_manifold_util.hpp:19-35): the live points' world
        positions and normals, separations and impulses. The normal points
        towards body_a, the lower body index."""
        from ..math import quat
        st = self.state
        man = st.contacts
        lo, hi = (a, b) if a < b else (b, a)
        key = int(lo) * st.capacity + int(hi)
        # host read: the table is slot-stable, not sorted by key
        hits = torch.nonzero((man.key == key) & man.valid).flatten()
        if hits.numel() == 0:
            return None
        idx = int(hits[0])
        pv = man.point_valid[idx].cpu().numpy()
        if not pv.any():
            return None
        ia, ib = int(man.body_a[idx]), int(man.body_b[idx])
        ppos = st.origin_pos()[ia] + quat.rotate(st.orn[ia], man.pivot_a[idx])
        # attachment: 0 world-space normal, 1 turns with A, 2 with B
        att = man.normal_attachment[idx][:, None]
        ln = man.local_normal[idx]
        nrm = torch.where(att == 1, quat.rotate(st.orn[ia], ln),
                          torch.where(att == 2, quat.rotate(st.orn[ib], ln),
                                      ln))
        h = lambda x: x.cpu().numpy()
        return {"body_a": ia, "body_b": ib, "num_points": int(pv.sum()),
                "point_valid": pv, "position": h(ppos), "normal": h(nrm),
                "distance": h(man.distance[idx]),
                "normal_impulse": h(man.normal_impulse[idx]),
                "friction_impulse": h(man.friction_impulse[idx])}

    def manifold_exists(self, a, b) -> bool:
        """reference: manifold_exists (util/contact_manifold_util.hpp:19)."""
        return self.manifold_between(a, b) is not None

    def step_with_events(self, n: int = 1):
        """Step and return the (started, ended) touching pairs (reference:
        the contact_started/ended signals). The step and the setters build
        new tensors, so the state kept here stays as it was."""
        from ..collision.events import contact_events
        prev = self.state
        self.step(n)
        return contact_events(prev, self.state)

    def query_aabb(self, lo, hi, include_non_procedural=True):
        """reference: include/edyn/collision/query_aabb.hpp."""
        from ..collision.events import query_aabb
        return query_aabb(self.state, lo, hi, include_non_procedural)

    def raycast(self, p0, p1):
        """Cast one ray or a batch (reference: edyn::raycast): fraction,
        entity (-1 on a miss), world normal and the feature detail
        (``raycast.FEAT_*``, sub index, compound child index); arrays for a
        batch, scalars for one ray."""
        from ..collision.raycast import raycast as _raycast
        f = numpy_dtype(self.state.dtype)
        p0 = np.atleast_2d(np.asarray(p0, f))
        p1 = np.atleast_2d(np.asarray(p1, f))
        out = _raycast(self.state, torch.as_tensor(p0, device=self.device),
                       torch.as_tensor(p1, device=self.device))
        out = {k: v.cpu().numpy() for k, v in out.items()}
        if p0.shape[0] == 1:
            return {"fraction": float(out["fraction"][0]),
                    "entity": int(out["entity"][0]),
                    "normal": out["normal"][0],
                    "feature": int(out["feature"][0]),
                    "sub_index": int(out["sub_index"][0]),
                    "child_index": int(out["child_index"][0])}
        return out

    # -- sleep ------------------------------------------------------------
    def wake_set(self, indices):
        """Wake exactly these bodies (no island walk)."""
        if not indices:
            return self
        idx = torch.as_tensor(sorted(indices), dtype=torch.long,
                              device=self.device)
        st = self.state
        asleep = st.asleep.clone()
        asleep[idx] = False
        timer = st.sleep_timer.clone()
        timer[idx] = 0.0
        self.state = dataclasses.replace(st, asleep=asleep,
                                         sleep_timer=timer)
        return self

    def put_to_sleep(self, indices=None):
        """Force bodies (default: every dynamic body) asleep now:
        velocities zeroed, sleep timer saturated. The island update keeps
        them asleep while their whole island stays quiet, the state the
        reference's timer-driven sleep converges to (island_manager.cpp
        put_islands_to_sleep)."""
        st = self.state
        mask = st.is_dynamic
        if indices is not None:
            chosen = torch.zeros_like(mask)
            chosen[torch.as_tensor(sorted(indices), dtype=torch.long,
                                   device=self.device)] = True
            mask = mask & chosen
        m3 = mask[:, None]
        self.state = dataclasses.replace(
            st, asleep=st.asleep | mask,
            sleep_timer=torch.where(
                mask, torch.full_like(st.sleep_timer, ISLAND_TIME_TO_SLEEP),
                st.sleep_timer),
            linvel=torch.where(m3, torch.zeros_like(st.linvel), st.linvel),
            angvel=torch.where(m3, torch.zeros_like(st.angvel), st.angvel))
        return self

    # -- runtime constraints (reference: make_constraint on a live registry,
    # util/constraint_util.hpp; constraints are destroyable entities) -------
    def _add_joint(self, **kw) -> int:
        """Write a joint into a free slot of the joint table. Ducks as
        ``WorldBuilder._add_joint``, so every ``constraints.api`` factory
        works on a live world: ``et.make_hinge_constraint(world, a, b,
        ...)``. The world needs spare slots
        (``make_world(max_joints=...)``)."""
        jt = self.state.joints
        free = torch.nonzero(~jt.valid).flatten()
        if free.numel() == 0:
            raise ValueError("joint table full: build the world with a "
                             "larger max_joints")
        i = int(free[0])
        params = np.zeros((jt.params.shape[1],), np.float64)
        p = np.asarray(kw.get("params", ()), np.float64)
        params[:len(p)] = p

        # a new table: earlier states keep theirs
        jt = dataclasses.replace(jt, **{f.name: getattr(jt, f.name).clone()
                                        for f in dataclasses.fields(jt)})
        jt.jtype[i] = int(kw["jtype"])
        jt.body_a[i] = int(kw["body_a"])
        jt.body_b[i] = int(kw["body_b"])
        jt.valid[i] = True
        jt.pivot_a[i] = self._host(kw.get("pivot_a", (0, 0, 0)))
        jt.pivot_b[i] = self._host(kw.get("pivot_b", (0, 0, 0)))
        jt.frame_a[i] = self._host(kw.get("frame_a", (0, 0, 0, 1)))
        jt.frame_b[i] = self._host(kw.get("frame_b", (0, 0, 0, 1)))
        jt.params[i] = self._host(params)
        jt.impulses[i] = 0.0
        jt.angle[i] = 0.0
        self.state = dataclasses.replace(self.state, joints=jt)
        # (destroy_joint keeps the type: a superset skips nothing it needs)
        self.meta = dataclasses.replace(
            self.meta, has_joints=True,
            joint_types=self.meta.joint_types | {JointType(int(kw["jtype"]))})
        # a new graph edge wakes both islands (island_manager on_construct)
        self.wake_up(int(kw["body_a"]))
        self.wake_up(int(kw["body_b"]))
        self._reset_island_stability()
        return i

    def destroy_joint(self, j: int):
        """Invalidate a joint and wake its islands (reference: destroying a
        constraint entity wakes the island, island_manager.cpp:74-98)."""
        jt = self.state.joints
        self.wake_up(int(jt.body_a[j]))
        self.wake_up(int(jt.body_b[j]))
        valid, jtype, imp = (jt.valid.clone(), jt.jtype.clone(),
                             jt.impulses.clone())
        valid[j] = False
        jtype[j] = 0
        imp[j] = 0.0
        self.state = dataclasses.replace(
            self.state, joints=dataclasses.replace(
                jt, valid=valid, jtype=jtype, impulses=imp))
        self._reset_island_stability()
        return self

    def _reset_island_stability(self):
        """Island-graph edges or pair eligibility changed outside the step:
        the next steps recompute the island labels (the steady-state label
        skip restarts) and re-enumerate the pairs (no pair-list carry)."""
        st = self.state
        self.state = dataclasses.replace(
            st,
            island_stable_steps=torch.zeros_like(st.island_stable_steps),
            labels_stable=torch.zeros_like(st.labels_stable),
            bp_carry_ok=torch.zeros_like(st.bp_carry_ok))

    def wake_up(self, i):
        """Wake the body's whole island (reference: wake_up_island), with
        membership from an exact host-side union-find over the live contact
        and joint edges, not the on-device labels (those fragment for 1-2
        steps after each re-seed)."""
        from ..dynamics.islands import exact_island_mask
        st = self.state
        members = exact_island_mask(st, [int(i)])
        self.state = dataclasses.replace(
            st,
            asleep=torch.where(members, False, st.asleep),
            sleep_timer=torch.where(members, 0.0, st.sleep_timer))
        return self

    def is_asleep(self, i) -> bool:
        return bool(self.state.asleep[i])

    def origin(self, i):
        """Shape-origin world position."""
        return self.state.origin_pos()[i].cpu().numpy()

    def overflow_counters(self) -> dict:
        """Last-step capacity-truncation counters (all zero = nothing was
        silently dropped)."""
        ovf = self.state.overflow.cpu().numpy()
        return {"broadphase_pairs": int(ovf[0]),
                "narrowphase_candidates": int(ovf[1]),
                "contact_rows": int(ovf[2]),
                "broadphase_window_alarms": int(ovf[3]),
                "manifold_slots": int(ovf[4])}


def make_world(builder: WorldBuilder, settings: Settings = Settings(),
               capacity: Optional[int] = None,
               max_pairs: Optional[int] = None,
               max_joints: Optional[int] = None, device=None) -> World:
    """Finalize a builder into a stepping world on ``device`` (default
    ``cuda``). The manifold table is sized to max_pairs; the joint table to
    max_joints (default: the builder's joints), so spare slots take
    runtime joints."""
    dev = resolve_device(device)
    if max_pairs is None:
        max_pairs = _pairs_for(len(builder.defs))
    if builder.default_gravity is None:
        builder.default_gravity = np.asarray(settings.gravity, np.float64)
    state = builder.finalize(capacity=capacity, max_manifolds=max_pairs,
                             max_joints=max_joints, device=dev)
    world = World(state, settings, derive_meta(state, max_pairs))
    world.user_component_policies = dict(builder.user_component_policies)
    return world
