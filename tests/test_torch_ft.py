"""The port's ``repro_torch.distributed.ft`` (a copy of
``repro.distributed.ft``): the daemon's operational shell — straggler
detection thresholds, preemption flagging + handler restore, heartbeat
liveness/staleness, elastic re-meshing.  Mirrors ``tests/test_ft.py``, and
holds the monitor and the re-mesh against the reference on the same inputs.

Tolerance: exact (the same Python float arithmetic in both packages).
"""

import os
import signal
import time

import numpy as np
import pytest

from repro.distributed import ft as ref_ft
from repro_torch.distributed import (
    Heartbeat,
    PreemptionGuard,
    StepMonitor,
    StragglerEvent,
    propose_mesh,
)

# ---------------------------------------------------------------------------
# StepMonitor
# ---------------------------------------------------------------------------


def test_step_monitor_flags_outlier_after_warmup():
    fired = []
    mon = StepMonitor(z_threshold=3.0, warmup=5, on_straggler=fired.append)
    for i in range(8):
        assert mon.observe(i, 0.010) is None
    ev = mon.observe(8, 0.5)
    assert isinstance(ev, StragglerEvent)
    assert ev.step == 8 and ev.duration_s == 0.5 and ev.zscore > 3.0
    assert mon.events == [ev] == fired


def test_step_monitor_outliers_do_not_poison_the_baseline():
    mon = StepMonitor(z_threshold=3.0, warmup=3)
    for i in range(6):
        mon.observe(i, 0.010)
    mean_before = mon.mean
    assert mon.observe(6, 5.0) is not None
    assert mon.mean == mean_before  # the spike is excluded from the EMA
    assert mon.observe(7, 0.010) is None  # steady steps still pass


def test_step_monitor_warmup_never_flags():
    mon = StepMonitor(z_threshold=0.0, warmup=4)
    assert mon.observe(0, 1.0) is None
    assert mon.observe(1, 100.0) is None  # wildly slow, but still warming up


def test_step_monitor_start_stop_pairs():
    mon = StepMonitor(warmup=2)
    mon.start()
    assert mon.stop(0) is None
    assert mon.count == 1
    with pytest.raises(AssertionError):
        mon.stop(1)  # stop() without start()


# ---------------------------------------------------------------------------
# Heartbeat
# ---------------------------------------------------------------------------


def test_heartbeat_beat_and_staleness(tmp_path):
    path = str(tmp_path / "hb")
    assert Heartbeat.is_stale(path, 1000.0)  # missing file is always stale
    hb = Heartbeat(path, interval_s=0.0)
    hb.beat(7)
    step, _stamp = open(path).read().split()
    assert int(step) == 7
    assert not Heartbeat.is_stale(path, 60.0)
    time.sleep(0.05)
    assert Heartbeat.is_stale(path, 0.01)


def test_heartbeat_respects_interval(tmp_path):
    path = str(tmp_path / "hb")
    hb = Heartbeat(path, interval_s=3600.0)
    hb.beat(1)  # first beat always writes
    content = open(path).read()
    hb.beat(2)  # inside the interval: no rewrite
    assert open(path).read() == content


# ---------------------------------------------------------------------------
# PreemptionGuard
# ---------------------------------------------------------------------------


def test_preemption_guard_flags_and_restores_handler():
    prev = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard(signals=(signal.SIGTERM,)) as guard:
        assert not guard.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted
    assert signal.getsignal(signal.SIGTERM) is prev


# ---------------------------------------------------------------------------
# propose_mesh
# ---------------------------------------------------------------------------


def test_propose_mesh_preserves_model_degree_when_divisible():
    assert propose_mesh(32, prefer_model=16) == (2, 16)
    assert propose_mesh(8, prefer_model=16) == (1, 8)
    assert propose_mesh(12, prefer_model=16) == (3, 4)
    assert propose_mesh(7, prefer_model=16) == (7, 1)
    assert propose_mesh(1) == (1, 1)
    with pytest.raises(ValueError):
        propose_mesh(0)


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_monitor_equals_reference_on_a_seeded_stream(seed):
    """The same step times give the same events, mean and variance."""
    rng = np.random.default_rng(seed)
    times = rng.exponential(0.01, 200) + (rng.random(200) < 0.05) * rng.random(200)
    mon, ref = StepMonitor(z_threshold=2.5, warmup=4), ref_ft.StepMonitor(z_threshold=2.5, warmup=4)
    for i, t in enumerate(times):
        got, want = mon.observe(i, float(t)), ref.observe(i, float(t))
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.step, got.duration_s, got.mean_s, got.zscore) == (
                want.step, want.duration_s, want.mean_s, want.zscore)
    assert (mon.mean, mon.var, mon.count, len(mon.events)) == (
        ref.mean, ref.var, ref.count, len(ref.events))
    assert mon.events


def test_propose_mesh_equals_reference():
    for n in range(1, 130):
        for prefer in (1, 2, 8, 16, 64):
            assert propose_mesh(n, prefer_model=prefer) == ref_ft.propose_mesh(n, prefer_model=prefer)
