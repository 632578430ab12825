"""Parity of the PyTorch port's foundations with the JAX package: the port's
imports, the world tables a builder produces, the numpy bridge between the
two states, the math helpers and the AABBs.

Inputs are drawn with numpy from a seed and fed to both packages; the port
runs on the CPU (``device="cpu"``)."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edyn_tpu as ej
from edyn_tpu.math import quat as jquat
from edyn_tpu.math import transform as jtransform
from edyn_tpu.math import vec as jvec
from edyn_tpu.shapes.aabb import compute_aabbs as j_compute_aabbs
from edyn_tpu.utils.scenes import mixed_pile as j_mixed_pile

import edyn_tpu_torch as et
from edyn_tpu_torch.core.convert import state_from_numpy, state_to_numpy
from edyn_tpu_torch.math import quat as tquat
from edyn_tpu_torch.math import transform as ttransform
from edyn_tpu_torch.math import vec as tvec
from edyn_tpu_torch.shapes.aabb import compute_aabbs as t_compute_aabbs
from edyn_tpu_torch.utils.scenes import mixed_pile as t_mixed_pile

from test_torch_step import jtree, one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def worlds():
    bj, _ = j_mixed_pile(n_bodies=64, seed=0)
    bt, _ = t_mixed_pile(n_bodies=64, seed=0)
    return ej.make_world(bj), et.make_world(bt, device="cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        sys.path.insert(0, {ROOT!r})
        import edyn_tpu_torch
        for m in pkgutil.walk_packages(edyn_tpu_torch.__path__,
                                       "edyn_tpu_torch."):
            importlib.import_module(m.name)
        for path in ("chip_smoke.py", "scripts/torch_step_profile.py",
                     "scripts/torch_device_diff.py",
                     "scripts/pile_floor_depth.py"):
            spec = importlib.util.spec_from_file_location(
                path.replace("/", "_")[:-3], {ROOT!r} + "/" + path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(n for n in sys.modules if n == "jax"
                     or n.startswith("jax.") or n == "edyn_tpu"
                     or n.startswith("edyn_tpu."))
        print(len([n for n in sys.modules if n.startswith("edyn_tpu_torch")]))
        assert not bad, bad
        for m in ("shapes.mesh", "shapes.compound", "collision.kernels.mesh",
                  "collision.kernels.compound"):
            assert "edyn_tpu_torch." + m in sys.modules, m
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20


def test_make_world_defaults_to_cuda_and_never_falls_back():
    b, _ = t_mixed_pile(n_bodies=8, seed=0)
    if torch.cuda.is_available():
        assert et.make_world(b).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            et.make_world(b)
    assert et.make_world(b, device="cpu").device.type == "cpu"


def test_mixed_pile_tables_equal(worlds):
    wj, wt = worlds
    a = dict(leaves(jtree(wj.state)))
    b = dict(leaves(state_to_numpy(wt.state)))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert wt.meta.max_pairs == wj.meta.max_pairs == 16 * 69
    assert wt.meta.types_present == wj.meta.types_present
    assert wt.meta.has_spin_roll == wj.meta.has_spin_roll


def test_state_round_trip(worlds):
    wj, _ = worlds
    x = jtree(wj.state)
    st = state_from_numpy(x, "cpu")
    assert st.pos.dtype == torch.float32
    assert st.contacts.key.dtype == torch.int64
    y = state_to_numpy(st)
    for (k, a), (k2, b) in zip(leaves(x), leaves(y)):
        assert k == k2 and a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)


def _rand(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q = f(256, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return dict(a=f(256, 3), b=f(256, 3), q=q, p=np.roll(q, 1, 0), w=f(256, 3),
                n=f(256, 3) / np.float32(3.0), m=np.abs(f(256)))


MATH = {
    "dot": (lambda m, x: m.dot(x["a"], x["b"])),
    "cross": (lambda m, x: m.cross(x["a"], x["b"])),
    "normalize": (lambda m, x: m.normalize(x["a"])),
    "orthonormal_basis": (lambda m, x: m.orthonormal_basis(m.normalize(
        x["n"]))),
    "clamp_length": (lambda m, x: m.clamp_length(x["a"], x["m"][:, None])),
}
QUAT = {
    "mul": (lambda m, x: m.mul(x["q"], x["p"])),
    "rotate": (lambda m, x: m.rotate(x["q"], x["a"])),
    "rotate_inv": (lambda m, x: m.rotate_inv(x["q"], x["a"])),
    "integrate": (lambda m, x: m.integrate(x["q"], x["w"], 1 / 60)),
    "to_matrix": (lambda m, x: m.to_matrix(x["q"])),
}
TRANSFORM = {
    "to_world_space": (lambda m, x: m.to_world_space(x["a"], x["b"], x["q"])),
    "to_object_space": (lambda m, x: m.to_object_space(x["a"], x["b"],
                                                       x["q"])),
    "to_world_dir": (lambda m, x: m.to_world_dir(x["a"], x["q"])),
    "to_object_dir": (lambda m, x: m.to_object_dir(x["a"], x["q"])),
}
CASES = ([("vec", k) for k in MATH] + [("quat", k) for k in QUAT]
         + [("transform", k) for k in TRANSFORM])


@pytest.mark.parametrize("module,fn", CASES,
                         ids=[f"{m}.{f}" for m, f in CASES])
def test_math_parity(module, fn):
    table, jm, tm = {"vec": (MATH, jvec, tvec), "quat": (QUAT, jquat, tquat),
                     "transform": (TRANSFORM, jtransform, ttransform)}[module]
    x = _rand(sum(map(ord, fn)))
    got = table[fn](tm, {k: torch.from_numpy(v) for k, v in x.items()})
    want = table[fn](jm, {k: jnp.asarray(v) for k, v in x.items()})
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_aabb_parity(worlds):
    wj, _ = worlds
    rng = np.random.default_rng(3)
    x = jtree(wj.state)
    q = rng.normal(size=x["orn"].shape).astype(np.float32)
    x["orn"] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x["pos"] = x["pos"] + rng.normal(size=x["pos"].shape).astype(np.float32)
    js = dataclasses.replace(wj.state, orn=jnp.asarray(x["orn"]),
                             pos=jnp.asarray(x["pos"]))
    ts = state_from_numpy(x, "cpu")
    jmin, jmax = j_compute_aabbs(js.shape_type, js.shape_params,
                                 js.origin_pos(), js.orn, js.poly,
                                 js.shape_index, js.mesh, js.convex)
    tmin, tmax = t_compute_aabbs(ts.shape_type, ts.origin_pos(), ts.orn,
                                 ts.convex)
    np.testing.assert_allclose(tmin.numpy(), np.asarray(jmin), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tmax.numpy(), np.asarray(jmax), rtol=1e-6,
                               atol=1e-6)
