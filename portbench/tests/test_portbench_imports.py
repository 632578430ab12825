"""Nothing the benchmark runs loads JAX or the JAX package ``edyn_tpu``
(top-level names compared whole: ``edyn_tpu_torch`` is the program), and
the references load nothing of the program (and the check written from
the step's semantics nothing of the frozen copy either)."""
from __future__ import annotations

import json
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "edyn_tpu"}

RUN = """
import json, sys, time
sys.path[0:0] = [{bench!r}, {root!r}]
import torch
torch.set_num_threads(2)
from pathlib import Path
import run  # the entry's own imports
from harness import runner, spec
cell = spec.load_cell("small.drop", Path({dst!r}))
runner.run_cell(cell, 5, 1.0, True, "cpu", time.perf_counter(),
                log=lambda line: None)
print(json.dumps(sorted(sys.modules)))
"""

REF = """
import json, sys
sys.path[0:0] = [{bench!r}]
import torch
torch.set_num_threads(2)
from harness import scene
from reference import compare, engine
cfg = json.load(open({cfg!r}))
cfg["scene"]["n_bodies"] = 40
cfg["world"].update(max_pairs=2048, max_rows=2048, bucket_cap=1024)
w = compare.reference_world(cfg, scene.mixed_pile(40, 3), torch.device("cpu"))
w.step(30)
compare.check_frames([], w, control=True)
engine.physics_step(compare.cast(w.state, torch.bfloat16), w.settings, w.meta)
print(json.dumps(sorted(sys.modules)))
"""


SEMANTICS = """
import json, sys
sys.path[0:0] = [{bench!r}]
import numpy as np
from harness import scene
from reference import semantics
desc = scene.mixed_pile(40, 3)
n = len(desc["planes"]) + 40
pre = dict(pos=np.zeros((n, 3)), orn=np.tile([0, 0, 0, 1.0], (n, 1)),
           linvel=np.zeros((n, 3)), angvel=np.zeros((n, 3)),
           asleep=np.zeros(n, bool), sleep_timer=np.zeros(n))
pre["pos"][5:] = desc["pos"]
host = np.concatenate([pre["pos"], pre["orn"]], 1)
semantics.check(desc, (0, -9.8, 0), 1 / 60,
                [(pre, host, (pre["linvel"], pre["angvel"]))], "bfloat16")
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str, whole: bool = False) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    names = json.loads(out.stdout.splitlines()[-1])
    return set(names) if whole else {m.split(".")[0] for m in names}


def test_the_run_loads_no_jax(tmp_path):
    from conftest import small_bench
    dst = small_bench(tmp_path)
    top = _modules(RUN.format(bench=str(dst), root=str(ROOT), dst=str(dst)))
    assert "edyn_tpu_torch" in top
    assert not top & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    top = _modules(REF.format(bench=str(BENCH),
                              cfg=str(BENCH / "configs" / "pile10k.json")))
    assert "reference" in top
    assert not top & (FORBIDDEN | {"edyn_tpu_torch"})


def test_the_semantic_check_loads_neither_the_program_nor_the_copy():
    loaded = _modules(SEMANTICS.format(bench=str(BENCH)), whole=True)
    assert "reference.semantics" in loaded
    top = {m.split(".")[0] for m in loaded}
    assert not top & (FORBIDDEN | {"edyn_tpu_torch"})
    assert not {m for m in loaded if m.startswith("reference.engine")}
