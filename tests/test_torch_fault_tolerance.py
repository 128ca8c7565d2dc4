"""The port's fault-tolerance host logic against the JAX package's.

``repro_torch.distributed.fault_tolerance`` is a copy of the reference's
pure-Python module; each scenario of ``tests/test_fault_tolerance.py``
runs through both on the same inputs and must give equal outputs.
"""

import numpy as np
import pytest

from repro.distributed import fault_tolerance as ref
from repro_torch.distributed import fault_tolerance as port


def straggler(ft):
    mon = ft.HeartbeatMonitor(num_hosts=4, straggler_threshold=2.0)
    for step in range(8):
        for h in range(4):
            dt = 1.0 if h != 2 else 5.0  # host 2 is slow
            mon.report(h, step, dt * step)
    return mon.stragglers(), [mon.step_times(h) for h in range(4)]


def dead_host(ft):
    mon = ft.HeartbeatMonitor(num_hosts=3, dead_timeout=10.0)
    now = 1000.0
    mon.report(0, 1, now - 1)
    mon.report(1, 1, now - 50)   # silent too long
    return sorted(mon.dead(now))  # host 2 never reported


def exclusion(ft):
    mon = ft.HeartbeatMonitor(num_hosts=2)
    mon.exclude(1)
    mon.report(1, 0)  # ignored
    mon.report(0, 0, 5.0)
    return mon.active_hosts, mon._beats[1], mon.dead(6.0), mon.stragglers()


def sliding_window(ft):
    mon = ft.HeartbeatMonitor(num_hosts=2, window=4)
    for step in range(10):
        mon.report(0, step, float(step))
        mon.report(1, step, 3.0 * step)
    return mon._beats[0], mon.step_times(1), mon.stragglers()


def ladder(ft):
    out = []
    for chips in (512, 500, 256, 230, 128, 17):
        shape, axes = ft.plan_remesh(chips)
        assert shape[axes.index("model")] == 16
        assert int(np.prod(shape)) <= chips
        out.append((shape, axes))
    return out


def degrade(ft):
    seq = [ft.plan_remesh(c)[0] for c in (512, 511, 255)]
    with pytest.raises(RuntimeError, match="cannot build a mesh"):
        ft.plan_remesh(8)
    return seq, ft.plan_remesh(64, require_model=16)


def elastic_batch(ft):
    return [ft.global_batch_for(*ft.plan_remesh(c), 8)
            for c in (512, 256, 128)]


def ladder_table(ft):
    return list(ft._MESH_LADDER)


@pytest.mark.parametrize("scenario", [
    straggler, dead_host, exclusion, sliding_window, ladder, degrade,
    elastic_batch, ladder_table], ids=lambda f: f.__name__)
def test_scenario_matches_the_reference(scenario):
    assert scenario(port) == scenario(ref)


def test_known_answers():
    assert straggler(port)[0] == [2]
    assert dead_host(port) == [1, 2]
    assert exclusion(port)[:2] == (1, [])
    assert elastic_batch(port) == [2 * 16 * 8, 16 * 8, 8 * 8]
