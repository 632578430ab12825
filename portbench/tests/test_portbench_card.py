"""On the card: one short traced run of a cell through the benchmark's own
command, its last line, and the profiler's count of each solver
kernel against the program's own."""
from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
def test_short_traced_run_on_the_card(cuda_device):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "pile10k.asleep",
         "--seed", str(2**31 + 101), "--seconds", "5", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] is True, res["check"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert {"launches_per_step", "device_idle_pct",
            "solver_roofline"} <= set(res["metrics"])
    assert 0 < res["metrics"]["solver_roofline"]["value"] <= 100
    line = next(l for l in out.stderr.splitlines()
                if l.startswith("solver kernels, traced launches"))
    pairs = re.findall(r"(\d+)/(\d+)", line)
    assert all(traced == counted for traced, counted in pairs), line
    assert any(int(counted) > 0 for _, counted in pairs), line
