"""The benchmark's files are found by name, and a run's last line keeps
the contract of ``BENCHMARK.json``."""
from __future__ import annotations

import hashlib
import json
import time

import pytest

from conftest import BENCH, CELLS, ROOT, jointed_bench, small_bench


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_name_resolves():
    from harness import spec
    bench = _bench()
    assert [w["name"] for w in bench["workloads"]] == list(CELLS)
    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert path == spec.config_file(c["name"])
        assert json.loads(path.read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert spec.scene_file(cell.config["scene"]["kind"]).exists()
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.limits) >= {"start_leaves_differ", "pos_gap_m",
                                    "free_pos_gap_m", "free_bodies_absent"}
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    # a split metric is read by its quantity's own reader
    assert spec.metric_file("steps_per_s.65k") == spec.metric_file(
        "steps_per_s")


def test_new_files_are_found_without_edits(tmp_path):
    """A new metric, and a jointed configuration with its own scene,
    traffic mix and limits (``jointed_bench``), are found in a copy of the
    benchmark by their names alone; the jointed cell runs on the CPU
    through ``runner.run_cell`` (what ``run.py`` calls on the card) to a
    ``correct`` result; no file of the harness changed."""
    from harness import runner, spec
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in BENCH.rglob("*.py") if "tests" not in p.parts}
    dst = jointed_bench(tmp_path)
    (dst / "metrics" / "frames_seen.py").write_text(
        "def read(ctx):\n    return ctx.frames\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(name="frames_seen", unit="frames",
                                   better="higher", source="host_clock",
                                   layer="test", moves="steps_per_s",
                                   workloads=["small.drop"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("small.drop", dst)
    assert cell.config["scene"]["n_bodies"] == 60
    assert cell.traffic["name"] == "drop"
    assert "frames_seen" in [m["name"] for m in cell.per_layer]
    assert spec.metric_reader("frames_seen", dst)(
        type("C", (), {"frames": 3})) == 3
    cell = spec.load_cell("chains.landing", dst)
    assert cell.config["scene"]["kind"] == "chains"
    assert spec.scene_file("chains", dst).exists()
    assert not spec.scene_file("chains").exists()
    res = runner.run_cell(cell, 2**31 + 73, 0.5, False, "cpu",
                          time.perf_counter(), log=lambda line: None)
    assert res["correct"] is True, res["check"]
    assert {"joint_pivot_gap_m", "free_group_pos_gap_m"} <= set(res["check"])
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest()
             for p in BENCH.rglob("*.py") if "tests" not in p.parts}
    assert before == after


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_matches_benchmark(tmp_path, trace):
    from harness import runner, spec
    dst = small_bench(tmp_path)
    cell = spec.load_cell("small.drop", dst)
    lines = []
    res = runner.run_cell(cell, 2**31 + 11, 1.5, bool(trace), "cpu",
                          time.perf_counter(), log=lines.append)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "check"
    assert res["correct"] is True and res["attempted"] >= 1
    units = {m["name"]: m["unit"]
             for m in cell.per_layer + cell.end_to_end}
    wanted = cell.per_layer if trace else cell.end_to_end
    for name, m in res["metrics"].items():
        assert name in [w["name"] for w in wanted]
        assert m["unit"] == units[name]
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    else:
        assert "breakdown" in res and "busy_s" in res["device"]
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert lines[-1].startswith("check ")
    json.dumps(res)
