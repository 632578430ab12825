"""The JAX package's async worker, presentation and profile tests
(``tests/test_async_and_profile.py``, all 7 but ``profile_step``, which
the port's spans replace: ``test_torch_profile.py``) on the port's CPU
worlds, and a stress test of the kernels' launch counts from several
threads: ``CASES[0:4]`` here, the others in
``test_torch_async_behaviour_b.py``."""
import time

import numpy as np
import pytest

import edyn_tpu_torch as et
from edyn_tpu_torch.simulation.async_worker import AsyncSimulation
from edyn_tpu_torch.simulation.presentation import Presentation
from edyn_tpu_torch.utils import profile
from edyn_tpu_torch.utils.scenes import hello_world
from test_torch_step import one_thread  # noqa: F401


def _world():
    b, box = hello_world()
    return et.make_world(b, device="cpu"), box


def async_worker_steps_and_applies_ops():
    w, box = _world()
    w.step(1)
    sim = AsyncSimulation(w).start()
    try:
        deadline = time.time() + 30.0
        while sim.steps_done < 10 and time.time() < deadline:
            time.sleep(0.05)
        assert sim.steps_done >= 10, "worker made no progress"
        st = sim.state
        assert float(st.pos[box][1]) < 3.0
        sim.apply_impulse(box, (50.0, 0, 0))
        base = sim.steps_done
        while sim.steps_done < base + 5 and time.time() < deadline:
            time.sleep(0.05)
        assert float(sim.state.linvel[box][0]) > 1.0
        assert sim.alive and sim.error is None
    finally:
        sim.stop()


def presentation_extrapolates():
    w, box = _world()
    w.step(30)
    pres = Presentation(w)
    st = w.state
    t = float(st.sim_time)
    pos_now, _ = pres.transforms(t)
    pos_later, _ = pres.transforms(t + 0.5 / 60.0)
    vy = float(st.linvel[box][1])
    np.testing.assert_allclose(pos_later[box][1] - pos_now[box][1],
                               vy * 0.5 / 60.0, atol=1e-5)


def presentation_discontinuity_decays():
    w, box = _world()
    w.step(5)
    pres = Presentation(w)
    pres.add_discontinuity([box], np.array([[1.0, 0, 0]], np.float32))
    for _ in range(30):
        pres.on_step()
    pos, _ = pres.transforms(float(w.state.sim_time))
    assert abs(pos[box][0] - float(w.state.pos[box][0])) < 0.05


def counters():
    w, box = _world()
    w.step(120)
    c = profile.counters(w.state)
    assert c.num_bodies == 2
    assert c.num_manifolds == 1
    assert c.num_contact_points >= 1
    assert c.num_islands == 1
    assert c.num_awake in (0, 1)


def async_raycast_and_query():
    w, box = _world()
    w.step(1)
    sim = AsyncSimulation(w).start()
    results = []
    try:
        sim.raycast_async((0.0, 5.0, 0.0), (0.0, -1.0, 0.0), results.append)
        sim.query_aabb_async((-1, -1, -1), (1, 10, 1), results.append)
        deadline = time.time() + 30.0
        while len(results) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert len(results) == 2
        ray = next(r for r in results if isinstance(r, dict))
        assert ray["entity"] >= 0
    finally:
        sim.stop()


def async_raycasts_are_batched():
    w, box = _world()
    w.step(1)
    sim = AsyncSimulation(w)
    results = []
    for k in range(100):
        x = (k % 10) * 0.01
        sim.raycast_async((x, 5.0, 0.0), (x, -1.0, 0.0), results.append)
    sim._flush_raycasts()
    assert len(results) == 100
    assert sim.raycast_batches == 1
    assert all(r["entity"] >= 0 for r in results)
    assert all(abs(r["normal"][1] - 1.0) < 1e-3 for r in results)


def launch_counts_from_threads():
    """The kernel wrappers count launches from every stepping thread (an
    AsyncSimulation, a client's extrapolation worker, the main thread):
    eight threads counting 20,000 launches each under a 1 us switch
    interval lose none."""
    import sys
    import threading
    from edyn_tpu_torch.utils import cuda_lib
    counts = {"k": 0}

    def work():
        for _ in range(20_000):
            cuda_lib.launched(counts, "k", 0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts["k"] == 8 * 20_000


CASES = [async_worker_steps_and_applies_ops, presentation_extrapolates,
         presentation_discontinuity_decays, counters,
         async_raycast_and_query, async_raycasts_are_batched,
         launch_counts_from_threads]


@pytest.mark.parametrize("case", CASES[0:4], ids=lambda f: f.__name__)
def test_behaviour(case):
    case()
