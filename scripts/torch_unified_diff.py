#!/usr/bin/env python3
"""Where K4 and ``support_sat.collide_support`` disagree, on one GPU.

    python3 scripts/torch_unified_diff.py [--bodies 10000] [--steps 120]
        [--out unified_diff.npz]

Steps ``mixed_pile(--bodies)`` for ``--steps`` steps on the card, then runs
the UNIFIED bucket's live pairs through K4 (the TPU kernel's formulation)
and through the port's ``support_sat.collide_support`` (the jnp path's),
and prints the distribution of the per-pair differences that
``tests/test_pallas_narrowphase.py``'s contract reads: contact existence,
deepest depth, the deepest point's normal, point count. The pairs beyond
the contract's limits are saved to ``--out`` with both packed side tables'
columns (``pack_side_table_t`` for K4, ``pack_side_table`` for support_sat),
so that the JAX package's two formulations can be run on exactly those
inputs on the CPU (``--replay``, which needs no GPU).

    python3 scripts/torch_unified_diff.py --replay unified_diff.npz
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

THRESHOLD = 0.01  # Settings.collision_threshold


def deepest(pv, dist, normal):
    """(has a point, deepest distance, its normal) per pair, numpy."""
    import numpy as np
    d = np.where(pv, dist, 1e9)
    i = d.argmin(-1)
    return (pv.any(-1), d.min(-1),
            np.take_along_axis(normal, i[:, None, None].repeat(3, -1),
                               1)[:, 0])


def compare(k4, sat):
    """Per-pair differences of two (point_valid, distance, normal)."""
    import numpy as np
    hk, dk, nk = deepest(*k4)
    hs, ds, ns = deepest(*sat)
    both = hk & hs
    depth = np.where(both, np.abs(dk - ds), 0.0)
    normal = np.where(both, np.abs(nk - ns).max(-1), 0.0)
    count = np.abs(k4[0].sum(-1) - sat[0].sum(-1))
    return dict(exist=hk != hs, depth=depth, normal=normal, count=count,
                both=both, shallow=both & (ds > -0.05))


def summary(c) -> dict:
    import numpy as np
    q = lambda x: [float(np.quantile(x[c["both"]], p))
                   for p in (0.5, 0.99, 0.999, 1.0)]
    return dict(pairs=len(c["both"]), with_contact=int(c["both"].sum()),
                existence_differs=int(c["exist"].sum()),
                depth_quantiles_50_99_999_max=q(c["depth"]),
                normal_quantiles_50_99_999_max=q(c["normal"]),
                depth_over_5e4=int((c["depth"] > 5e-4).sum()),
                normal_over_2e3=int((c["normal"] > 2e-3).sum()),
                shallow_count_over_1=int((c["count"][c["shallow"]] > 1)
                                         .sum()))


def beyond(c):
    return c["exist"] | (c["depth"] > 5e-4) | (c["normal"] > 2e-3)


def on_card(a) -> int:
    import numpy as np
    import torch
    import edyn_tpu_torch as et
    from edyn_tpu_torch.collision import narrowphase as nph
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    from edyn_tpu_torch.collision.kernels.support import (pack_side_table,
                                                          side_from_packed)
    from edyn_tpu_torch.collision.kernels.support_sat import collide_support
    from edyn_tpu_torch.utils.scenes import mixed_pile
    if not torch.cuda.is_available():
        print("torch_unified_diff: no CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    w = et.make_world(mixed_pile(n_bodies=a.bodies, seed=0)[0])
    w.step_n(a.steps)
    st = w.state
    cls, _, _, _ = nph.live_classes(st, st.contacts)
    sel = (cls == nph.B_UNIFIED).nonzero()[:, 0]
    ka = st.contacts.body_a[sel].long()
    kb = st.contacts.body_b[sel].long()
    tbl, dims = uk.pack_side_table_t(st)
    out = uk.collide_support_unified(tbl, ka, kb, dims, THRESHOLD, True)
    packed, pdims = pack_side_table(st)
    parts = []
    for c0 in range(0, len(ka), nph.CHUNK):
        s = slice(c0, c0 + nph.CHUNK)
        parts.append(collide_support(side_from_packed(packed[ka[s]], pdims),
                                     side_from_packed(packed[kb[s]], pdims),
                                     THRESHOLD, rim_axes=True))
    k4 = (out[..., 11].cpu().numpy() > 0.5, out[..., 10].cpu().numpy(),
          out[..., 6:9].cpu().numpy())
    sat = tuple(torch.cat([getattr(r, f) for r in parts]).cpu().numpy()
                for f in ("point_valid", "distance", "normal"))
    c = compare(k4, sat)
    far = np.nonzero(beyond(c))[0]
    idx = torch.from_numpy(far).to(ka.device)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    np.savez(a.out, ta=tbl[:, ka[idx]].cpu().numpy(),
             tb=tbl[:, kb[idx]].cpu().numpy(),
             pa=packed[ka[idx]].cpu().numpy(),
             pb=packed[kb[idx]].cpu().numpy(), dims=np.array(dims),
             pdims=np.array(pdims), k4_out=out[idx].cpu().numpy(),
             types=np.stack([st.shape_type[ka[idx]].cpu().numpy(),
                             st.shape_type[kb[idx]].cpu().numpy()], 1))
    print(json.dumps({"gpu": gpu, "bodies": a.bodies, "steps": a.steps,
                      "k4_vs_support_sat": summary(c),
                      "beyond_contract": far.tolist(), "saved": a.out}))
    return 0


def replay(path) -> int:
    """On the CPU: the saved pairs through the JAX package's K4 body (op by
    op) and its jnp support_sat, beside the port's plain K4 and
    support_sat."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from edyn_tpu.collision.kernels import pallas_unified as pu
    from edyn_tpu.collision.kernels import support as jsup
    from edyn_tpu.collision.kernels import support_sat as jsat
    from edyn_tpu_torch.collision.kernels import unified_kernel as uk
    from edyn_tpu_torch.collision.kernels import support as tsup
    from edyn_tpu_torch.collision.kernels import support_sat as tsat

    z = np.load(path)
    dims, pdims = tuple(int(x) for x in z["dims"]), tuple(
        int(x) for x in z["pdims"])
    K = z["ta"].shape[1]
    if K == 0:
        print(json.dumps({"pairs": 0}))
        return 0

    class Sink:
        def __setitem__(self, key, value):
            self.value = value
    sink = Sink()
    with jax.disable_jit():
        pu._make_kernel(dims, THRESHOLD, True)(jnp.asarray(z["ta"]),
                                               jnp.asarray(z["tb"]), sink)
        jk4 = np.asarray(sink.value).T.reshape(K, 4, 12)
        r = jsat.collide_support(jsup.side_from_packed(jnp.asarray(z["pa"]),
                                                       pdims),
                                 jsup.side_from_packed(jnp.asarray(z["pb"]),
                                                       pdims),
                                 THRESHOLD, rim_axes=True)
    jsat_out = tuple(np.asarray(getattr(r, f))
                     for f in ("point_valid", "distance", "normal"))
    tk4 = uk.collide_support_plain(torch.from_numpy(z["ta"]),
                                   torch.from_numpy(z["tb"]), dims,
                                   THRESHOLD, True).numpy()
    r = tsat.collide_support(tsup.side_from_packed(torch.from_numpy(z["pa"]),
                                                   pdims),
                             tsup.side_from_packed(torch.from_numpy(z["pb"]),
                                                   pdims),
                             THRESHOLD, rim_axes=True)
    tsat_out = tuple(getattr(r, f).numpy()
                     for f in ("point_valid", "distance", "normal"))
    unpack = lambda o: (o[..., 11] > 0.5, o[..., 10], o[..., 6:9])
    rows = []
    for k in range(K):
        d = lambda x: deepest(*(v[k:k + 1] for v in x))
        rows.append(dict(
            pair=k, types=z["types"][k].tolist(),
            card_k4=float(d(unpack(z["k4_out"]))[1][0]),
            jax_k4=float(d(unpack(jk4))[1][0]),
            port_k4_cpu=float(d(unpack(tk4))[1][0]),
            jax_support_sat=float(d(jsat_out)[1][0]),
            port_support_sat_cpu=float(d(tsat_out)[1][0])))
    jc = compare(unpack(jk4), jsat_out)
    print(json.dumps({"pairs": K, "deepest_distance": rows,
                      "jax_k4_vs_jax_support_sat": summary(jc)}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bodies", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--out", default="unified_diff.npz")
    ap.add_argument("--replay", default=None)
    a = ap.parse_args()
    return replay(a.replay) if a.replay else on_card(a)


if __name__ == "__main__":
    sys.exit(main())
