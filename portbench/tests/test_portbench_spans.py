"""The per-layer metrics that read the program's own spans and counters
(``harness/spans.py``): a traced CPU run of the small cell reads each of
them, and each reads nothing when the program's recorded steps are not
the traced frames."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from conftest import small_bench

NEW = ("broadphase_ms", "narrowphase_ms", "islands_ms", "rows_ms",
       "solve_ms", "host_syncs_per_step", "restitution_passes_per_step")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    from edyn_tpu_torch.utils import profile
    from harness import runner, spec
    dst = small_bench(tmp_path_factory.mktemp("spans"))
    cell = spec.load_cell("small.drop", dst)
    profile.reset()    # one cell a process, as run.py runs it
    res = runner.run_cell(cell, 2**31 + 47, 2.0, True, "cpu",
                          time.perf_counter(), log=lambda line: None)
    return cell, dst, res, profile.recorded()


def test_a_traced_run_reads_every_new_metric(traced):
    cell, _, res, rec = traced
    assert res["correct"] is True
    for name in NEW:
        assert name in [m["name"] for m in cell.per_layer]
        assert name in res["metrics"], name
        assert res["metrics"][name]["value"] >= 0
    frames = rec["steps"]
    assert frames >= 1
    assert res["metrics"]["host_syncs_per_step"]["value"] \
        == rec["counters"]["host_syncs"] / frames
    phases = sum(res["metrics"][f"{n}_ms"]["value"]
                 for n in ("broadphase", "narrowphase", "islands", "rows",
                           "solve"))
    assert 0 < phases <= rec["spans"]["step"]["device_ms"] / frames


@pytest.mark.parametrize("name", NEW)
def test_nothing_is_read_unless_the_steps_are_the_frames(traced, name):
    from harness import spec
    _, dst, _, rec = traced
    read = spec.metric_reader(name, dst)
    for frames in (rec["steps"] + 1, rec["steps"] - 1, 0):
        assert read(SimpleNamespace(trace=dict(frames=frames))) is None
    assert read(SimpleNamespace(trace=None)) is None
    assert read(SimpleNamespace(trace=dict(frames=rec["steps"]))) \
        is not None
