"""Fault-tolerance utilities: straggler detection, preemption, heartbeat,
elastic re-meshing (a copy of ``repro.distributed.ft``, whose package
``__init__`` imports JAX).

All components are host-side and framework-agnostic:

* :class:`StepMonitor` — per-step wall-time EMA + z-score straggler detector.
  The serve daemon keeps one per slab stream and one for whole ticks; the
  callback records the event.
* :class:`PreemptionGuard` — SIGTERM/SIGINT → "drain now" flag, the
  standard preemptible-VM protocol (maintenance events give ~30 s notice).
* :class:`Heartbeat` — liveness file for an external watchdog; a missing or
  stale heartbeat is how the cluster controller detects a hung host.
* :func:`propose_mesh` — elastic re-meshing: given the surviving device
  count, pick the closest (data, model) factorization that preserves the
  model-parallel degree when possible.
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import time
from typing import Callable, List, Optional, Tuple


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    mean_s: float
    zscore: float


class StepMonitor:
    """EMA + variance tracker over step wall times; flags z-score outliers.

    ``on_straggler`` fires when a step exceeds ``z_threshold`` standard
    deviations above the mean (after ``warmup`` steps).  In a real deployment
    the callback initiates checkpoint-and-reshard; here it is observable.
    """

    def __init__(
        self,
        z_threshold: float = 3.0,
        decay: float = 0.95,
        warmup: int = 5,
        on_straggler: Optional[Callable[[StragglerEvent], None]] = None,
    ):
        self.z = z_threshold
        self.decay = decay
        self.warmup = warmup
        self.on_straggler = on_straggler
        self.mean = 0.0
        self.var = 0.0
        self.count = 0
        self.events: List[StragglerEvent] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> Optional[StragglerEvent]:
        assert self._t0 is not None, "stop() without start()"
        dt = time.monotonic() - self._t0
        self._t0 = None
        return self.observe(step, dt)

    def observe(self, step: int, duration_s: float) -> Optional[StragglerEvent]:
        self.count += 1
        if self.count <= self.warmup:
            # seed statistics
            d = self.decay if self.count > 1 else 0.0
            self.mean = d * self.mean + (1 - d) * duration_s
            self.var = d * self.var + (1 - d) * (duration_s - self.mean) ** 2
            return None
        std = math.sqrt(max(self.var, 1e-12))
        zscore = (duration_s - self.mean) / std
        event = None
        if zscore > self.z:
            event = StragglerEvent(step, duration_s, self.mean, zscore)
            self.events.append(event)
            if self.on_straggler:
                self.on_straggler(event)
        else:
            # only fold non-outliers into the statistics
            self.mean = self.decay * self.mean + (1 - self.decay) * duration_s
            self.var = self.decay * self.var + (1 - self.decay) * (
                duration_s - self.mean
            ) ** 2
        return event


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that set a should-checkpoint flag."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flagged = False
        self._signals = signals
        self._prev = {}

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        self._flagged = True

    @property
    def preempted(self) -> bool:
        return self._flagged


class Heartbeat:
    """Liveness file: mtime is the heartbeat; watchdogs restart stale hosts."""

    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self, step: int) -> None:
        now = time.time()
        if now - self._last >= self.interval_s:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{step} {now}\n")
            os.replace(tmp, self.path)
            self._last = now

    @staticmethod
    def is_stale(path: str, max_age_s: float) -> bool:
        try:
            return (time.time() - os.path.getmtime(path)) > max_age_s
        except OSError:
            return True


def propose_mesh(n_devices: int, prefer_model: int = 16) -> Tuple[int, int]:
    """Elastic re-mesh: (data, model) for the surviving device count.

    Keeps the model-parallel degree at ``prefer_model`` when divisible
    (parameter shards stay aligned with the checkpoint layout); otherwise
    falls back to the largest power-of-two model degree that divides.
    """
    if n_devices <= 0:
        raise ValueError("no devices")
    model = prefer_model
    while model > 1 and n_devices % model != 0:
        model //= 2
    return n_devices // model, model
