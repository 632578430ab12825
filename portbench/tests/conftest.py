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
