"""What a run reads before it starts: ``BENCHMARK.json`` at the root of the
checkout, and the files it names, each found by its name alone.

- ``configs/<config>.json``: one configuration (scene, sizes, settings);
- ``scenes/<kind>.py``: the scene a configuration's ``scene.kind`` names
  (``harness.scene`` says what it gives);
- ``traffic/<traffic>.json``: one traffic mix, the parameters that
  ``harness.traffic`` reads;
- ``metrics/<metric>.py``: one metric, a ``read(ctx)`` function; a metric
  ``<metric>.<part>`` without a file of its own is the same quantity, read
  by ``metrics/<metric>.py``, split off for the cells that report another
  end-to-end metric or hold a bound of their own;
- ``limits/<workload>.json``: the limits that decide a cell's ``correct``.

A new cell, configuration, scene, mix or metric is a new entry in
``BENCHMARK.json`` and a new file here: nothing that exists is edited.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # BENCHMARK.json entries reported with --trace 0
    per_layer: list       # entries reported with --trace 1
    limits: dict
    bench_dir: Path


def benchmark_file(bench_dir: Path = BENCH_DIR) -> Path:
    return Path(bench_dir).parent / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def config_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return Path(bench_dir) / "configs" / f"{name}.json"


def traffic_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return Path(bench_dir) / "traffic" / f"{name}.json"


def scene_file(kind: str, bench_dir: Path = BENCH_DIR) -> Path:
    return Path(bench_dir) / "scenes" / f"{kind}.py"


def metric_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    """``metrics/<name>.py``, else, for a name ``<metric>.<part>``,
    ``metrics/<metric>.py``."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        return metric_file(name.rsplit(".", 1)[0], bench_dir)
    return path


def limits_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return Path(bench_dir) / "limits" / f"{name}.json"


def load_cell(workload: str, bench_dir: Path = BENCH_DIR,
              bench: dict | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its files; raises
    when the cell or one of its files is missing."""
    bench_dir = Path(bench_dir)
    bench = bench or load_json(benchmark_file(bench_dir))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    config = load_json(config_file(w["config"], bench_dir))
    if not scene_file(config["scene"]["kind"], bench_dir).exists():
        raise FileNotFoundError(
            f"no scene {config['scene']['kind']!r} for {workload!r}")
    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        traffic=load_json(traffic_file(w["traffic"], bench_dir)),
        end_to_end=[m for m in bench["end_to_end"]
                    if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
        limits=load_json(limits_file(workload, bench_dir)),
        bench_dir=bench_dir)


def load_module(path: Path, name: str):
    """The module of a benchmark file, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    return load_module(metric_file(name, bench_dir),
                       f"portbench_metric_{name}").read


def scene_module(kind: str, bench_dir: Path = BENCH_DIR):
    """The module of ``scenes/<kind>.py`` (``describe``, ``build``,
    ``small``)."""
    return load_module(scene_file(kind, bench_dir), f"portbench_scene_{kind}")
