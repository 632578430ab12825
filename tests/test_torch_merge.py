"""The narrowphase's manifold merge: the port's ``manifold.merge_points``
held to the JAX package's, to the bit, at float32 and float64, on the
crafted tables of ``collision/kernels/merge_cases.py`` (one rule of the
merge each: nearest ties, claim ties, replacement by area, rolling
matches, breaking, attachments, frozen and invalid slots), run through
``merge_fresh`` on the CPU as the step runs it; and the merge kernel's
wrapper, which takes the plain version only for CPU tensors. The merge
kernel itself is held to the plain version on the card by
``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edyn_tpu.collision import manifold as jman
from edyn_tpu.core.state import ContactTable as JContactTable
from edyn_tpu_torch.collision import narrowphase as tnp_phase
from edyn_tpu_torch.collision.kernels import merge_cases
from edyn_tpu_torch.collision.kernels import merge_kernel as mk
from test_torch_step import one_thread  # noqa: F401

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _jax(x):
    x = x.numpy()
    return jnp.asarray(x.astype(np.uint32) if x.dtype == np.int64 else x)


def _bits(x):
    x = np.asarray(x)
    if x.dtype == np.float64:
        return x.view(np.int64)
    if x.dtype == np.float32:
        return x.view(np.int32)
    return x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", merge_cases.CASES)
def test_merge_points_crafted(case, dtype, monkeypatch):
    c = merge_cases.build(case, DTYPES[dtype])
    seen = {}

    def spy(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        seen["out"] = out = jman_port(*args, **kw)
        return out

    jman_port = mk.merge_points
    monkeypatch.setattr(mk, "merge_points", spy)
    got = tnp_phase.merge_fresh(c.bodies, c.table, c.new_pts, c.frozen, c.dt)
    assert merge_cases.check(case, c, got) == []

    man, *arrays = seen["args"]
    kw = seen["kw"]
    jt = JContactTable(**{f.name: _jax(getattr(man, f.name))
                          for f in dataclasses.fields(man)})
    with jax.enable_x64(dtype == "float64"), jax.disable_jit():
        want = jman.merge_points(
            jt, *map(_jax, arrays), pose=tuple(map(_jax, kw["pose"])),
            dt=kw["dt"], scales=_jax(kw["scales"]))
        want = {f: np.asarray(getattr(want, f)) for f in mk.FIELDS}
    merged = seen["out"]
    fr = (c.frozen & c.table.valid).numpy()
    for f in mk.FIELDS:
        g, w = getattr(merged, f).numpy(), want[f]
        if g.dtype != w.dtype:
            # the JAX package's float64 merge rounds some impulse and
            # distance columns to float32 (its merge_points' f), which the
            # cases' float32 numbers survive: widened exactly
            assert (g.dtype, w.dtype) == (np.float64, np.float32), f
            w = w.astype(np.float64)
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f)
        # frozen pairs keep the carried table's fields
        keep = fr.reshape(fr.shape + (1,) * (g.ndim - 1))
        np.testing.assert_array_equal(
            _bits(getattr(got, f).numpy()),
            _bits(np.where(keep, getattr(c.table, f).numpy(), g)),
            err_msg=f)


def test_merge_wrapper_takes_the_plain_version_only_on_the_cpu():
    """CPU tensors take the plain merge and count no launch; tensors on
    two devices, or on a device without the kernel, raise."""
    c = merge_cases.build("random")
    mk.reset_launch_counts()
    got = mk.merge_fresh(c.bodies, c.table, c.new_pts, c.frozen, c.dt)
    want = mk.merge_fresh_plain(c.bodies, c.table, c.new_pts, c.frozen,
                                c.dt)
    for f in mk.FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert not any(mk.LAUNCHES.values()) and not any(
        mk.LAUNCHES_F64.values())
    with pytest.raises(ValueError):
        mk.merge_fresh(c.bodies, c.table, c.new_pts.to("meta"), c.frozen,
                       c.dt)
    meta = merge_cases.build("random", torch.float16, device="meta")
    with pytest.raises(ValueError):
        mk.merge_fresh(meta.bodies, meta.table, meta.new_pts, meta.frozen,
                       meta.dt)
    with pytest.raises(TypeError):
        mk._entry(torch.float16)
    assert not any(mk.LAUNCHES.values())
