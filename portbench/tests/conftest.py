"""Shared set-up of the benchmark's own tests.

    python -m pytest portbench/tests -q              # here, on the CPU
    python -m pytest portbench/tests -q -m card      # on a machine with a card

Tests marked ``card`` need a CUDA device; each decides inside itself,
through the ``cuda_device`` fixture, whether there is one. The others run
the harness on the CPU at a small size: a copy of ``portbench/`` in a
temporary directory with one small cell added, as a later change adds one.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("pile65k.drop", "pile10k.drop", "pile10k.asleep")


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card's tests run on the chip")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_bench(tmp: Path, traffic: str = "drop", n_bodies: int = 60,
                limits_of: str = "pile10k.drop") -> Path:
    """A copy of the benchmark under ``tmp`` with a cell ``small.<traffic>``
    of ``n_bodies`` bodies added as new files and entries only; returns the
    copy's ``portbench`` directory."""
    dst = tmp / "portbench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "pile10k.json").read_text())
    cfg.update(name="small")
    cfg["scene"] = dict(cfg["scene"], n_bodies=n_bodies)
    cfg["world"] = dict(cfg["world"], max_pairs=4096, max_rows=4096,
                        bucket_cap=2048)
    (dst / "configs" / "small.json").write_text(json.dumps(cfg))
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    tr["warm"] = dict(pile_bodies=27, pile_steps=3, frames=1)
    if traffic == "asleep":
        tr["prelude"][0]["n"] = 40
        tr["prelude"][1]["count"] = 5
        tr["episode_frames"] = 4
    (dst / "traffic" / f"small_{traffic}.json").write_text(json.dumps(tr))
    name = f"small.{traffic}"
    shutil.copy(BENCH / "limits" / f"{limits_of}.json",
                dst / "limits" / f"{name}.json")
    bench["configs"].append(dict(name="small", source="test", reduced=[],
                                 file="portbench/configs/small.json",
                                 why="a small copy for the CPU"))
    bench["workloads"].append(dict(name=name, config="small", chips=1,
                                   traffic=f"small_{traffic}", why="test"))
    # the small cell reports what the 10k cells report
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "pile10k.drop" in m["workloads"]:
            m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


# the jointed cell's own limits beside the pile's: the free groups' as the
# free bodies', and joints held within a quarter metre (a torn joint reads
# metres)
JOINT_LIMITS = dict(free_group_pos_gap_m=0.001,
                    free_group_linvel_gap_mps=0.0001,
                    joint_pivot_gap_m=0.25)


def jointed_bench(tmp: Path, n_chains: int = 4) -> Path:
    """``small_bench`` with a jointed cell ``chains.landing`` added as a
    later configuration adds one, in new files and entries only: the scene
    ``tests/scenes/chains.py`` as ``scenes/chains.py``; a configuration of
    ``n_chains`` chains, every other one dropped 2 m higher; a mix that
    steps 20 frames first, so that every frame of the window holds landed
    chains, whose joints work, and falling ones, which the independent
    check judges as free groups; and limits of its own."""
    dst = small_bench(tmp)
    tr = json.loads((dst / "traffic" / "small_drop.json").read_text())
    tr.update(name="landing", prelude=[dict(op="step", n=20)])
    (dst / "traffic" / "landing.json").write_text(json.dumps(tr))
    shutil.copy(BENCH / "tests" / "scenes" / "chains.py",
                dst / "scenes" / "chains.py")
    cfg = json.loads((dst / "configs" / "small.json").read_text())
    cfg.update(name="chains", scene=dict(kind="chains", n_chains=n_chains,
                                         height=1.7, stagger=2.0))
    cfg["settings"]["cone_max_violation"] = 2.0
    (dst / "configs" / "chains.json").write_text(json.dumps(cfg))
    limits = json.loads((BENCH / "limits" / "pile10k.drop.json").read_text())
    limits.update(JOINT_LIMITS)
    (dst / "limits" / "chains.landing.json").write_text(json.dumps(limits))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="chains", source="test", reduced=[],
                                 file="portbench/configs/chains.json",
                                 why="jointed chains for the CPU"))
    bench["workloads"].append(dict(name="chains.landing", config="chains",
                                   chips=1, traffic="landing", why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "small.drop" in m["workloads"]:
            m["workloads"].append("chains.landing")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def falling_frame(n=40, seed=3, asleep_every=0, nudge=0.0):
    """A frame of the pile's bodies falling as built (or asleep, every
    ``asleep_every``-th one), stepped as the semantics say, its second
    body read back ``nudge`` metres higher: (desc, pre, host, post_vel)."""
    import numpy as np
    from harness import scene
    from reference import semantics
    desc = scene.mixed_pile(n, seed)
    s = len(desc["planes"])
    rng = np.random.default_rng(seed)
    pos = np.zeros((s + n, 3))
    pos[s:] = desc["pos"]
    pos[s:, 1] += 5.0
    orn = np.zeros((s + n, 4))
    orn[:, 3] = 1
    orn[s:] = desc["orn"]
    lin = np.zeros((s + n, 3))
    lin[s:, 1] = -2.0
    ang = np.zeros((s + n, 3))
    ang[s:] = rng.normal(size=(n, 3))
    asleep = np.zeros(s + n, bool)
    if asleep_every:
        asleep[s::asleep_every] = True
        lin[asleep] = ang[asleep] = 0
    pre = dict(pos=pos.astype(np.float32), orn=orn.astype(np.float32),
               linvel=lin.astype(np.float32), angvel=ang.astype(np.float32),
               asleep=asleep, sleep_timer=np.zeros(s + n, np.float32))
    x, q, v, w = semantics.ballistic(pre["pos"], pre["orn"], pre["linvel"],
                                     pre["angvel"], (0, -9.8, 0), 1 / 60,
                                     np.float32)
    x[asleep], q[asleep] = pre["pos"][asleep], pre["orn"][asleep]
    v[asleep] = w[asleep] = 0
    host = np.concatenate([x, q], 1)
    host[s + 1, 1] += nudge
    return desc, pre, host, (v, w)
