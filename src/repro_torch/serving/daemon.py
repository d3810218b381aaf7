"""The long-lived serve daemon: arrivals in, ticks through, liveness out (the
port of ``repro.serving.daemon``).

Wraps a :class:`repro_torch.serving.scheduler.ContinuousEngine` with the
operational shell a deployment needs — all of it from the fault-tolerance
module :mod:`repro_torch.distributed.ft`:

* :class:`PreemptionGuard` — SIGTERM flips a flag; the loop finishes the
  tick, stops admitting, and drains (in-flight slabs complete; queued
  requests are served or shed, by policy).
* :class:`Heartbeat` — liveness file beaten every tick; it goes stale when
  the daemon exits, which is exactly how a watchdog notices.
* :class:`StepMonitor` — one monitor for whole ticks plus one per slab
  stream, flagging per-slab latency anomalies (a slab suddenly settling
  slower than its own history).

Latency is measured per request from submission to the resolution of its
future (a done-callback), on the host clock; rejected and failed requests
are not counted.
"""

from __future__ import annotations

import signal as signal_lib
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from repro_torch.distributed.ft import Heartbeat, PreemptionGuard, StepMonitor
from repro_torch.engine.engine import QueueFullError, Request
from repro_torch.serving.scheduler import ContinuousEngine


def percentile(sorted_values: List[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (0 <= q <= 100)."""
    if not sorted_values:
        return 0.0
    rank = max(0, min(len(sorted_values) - 1, int(round(q / 100.0 * (len(sorted_values) - 1)))))
    return sorted_values[rank]


class ServeDaemon:
    """Drives a :class:`ContinuousEngine` from a request source.

    ``source`` (see :meth:`run`) yields arrivals per tick; the daemon
    submits them, ticks the scheduler, beats the heartbeat, and watches
    per-slab latency.  It exits when the source is exhausted and the engine
    is idle, or after a preemption drain.

    Parameters
    ----------
    heartbeat_path / heartbeat_interval_s:
        Liveness file (``None`` disables).  ``interval_s=0`` beats every tick.
    straggler_z / monitor_warmup:
        Per-slab :class:`StepMonitor` thresholds.
    drain_queue_on_term:
        After SIGTERM: ``True`` serves the remaining queue before exit;
        ``False`` (default) completes in-flight lanes only and rejects the
        queue with :class:`repro_torch.serving.scheduler.DrainRejectedError`.
    signals:
        Signals the :class:`PreemptionGuard` traps.  Pass ``()`` when the
        caller owns signal handling (e.g. nested inside another guard).
    max_ticks:
        Hard tick bound (safety for tests and smoke runs; ``None`` = no cap).
    idle_sleep_s:
        Sleep this long after a tick that had no arrivals and did no work,
        instead of spinning on the arrival clock (an open-loop source emits
        ``None`` between arrivals; busy-ticking it would steal CPU from the
        in-flight solves).  0 disables.
    """

    def __init__(
        self,
        engine: ContinuousEngine,
        *,
        heartbeat_path: Optional[str] = None,
        heartbeat_interval_s: float = 0.0,
        straggler_z: float = 4.0,
        monitor_warmup: int = 5,
        drain_queue_on_term: bool = False,
        signals: Tuple[Any, ...] = (signal_lib.SIGTERM,),
        max_ticks: Optional[int] = None,
        idle_sleep_s: float = 0.0,
    ) -> None:
        self.engine = engine
        self.heartbeat = (
            Heartbeat(heartbeat_path, interval_s=heartbeat_interval_s)
            if heartbeat_path
            else None
        )
        self.straggler_z = straggler_z
        self.monitor_warmup = monitor_warmup
        self.drain_queue_on_term = drain_queue_on_term
        self.signals = tuple(signals)
        self.max_ticks = max_ticks
        self.idle_sleep_s = idle_sleep_s
        self.tick_monitor = StepMonitor(z_threshold=straggler_z, warmup=monitor_warmup)
        self.slab_monitors: Dict[str, StepMonitor] = {}
        self._latencies: List[float] = []
        self._rejected_at_admission = 0

    # -- submission with latency bookkeeping -------------------------------

    def _submit(self, request: Request) -> bool:
        t_arrival = time.perf_counter()
        try:
            fut = self.engine.submit(request)
        except QueueFullError:
            self._rejected_at_admission += 1
            return False
        fut.add_done_callback(
            lambda f, t=t_arrival: (
                self._latencies.append(time.perf_counter() - t)
                if f.exception() is None
                else None
            )
        )
        return True

    def _pull(self, source: Iterator[Any]) -> Tuple[List[Request], bool]:
        """Next tick's arrivals; returns (requests, stream_closed)."""
        try:
            item = next(source)
        except StopIteration:
            return [], True
        if item is None:
            return [], False
        if isinstance(item, Request):
            return [item], False
        return list(item), False

    def _observe_slabs(self, slab_seconds: Dict[str, float], tick: int) -> None:
        for label, dt in slab_seconds.items():
            mon = self.slab_monitors.setdefault(
                label,
                StepMonitor(z_threshold=self.straggler_z, warmup=self.monitor_warmup),
            )
            mon.observe(tick, dt)

    # -- the loop ----------------------------------------------------------

    def run(self, source: Iterable[Any]) -> Dict[str, Any]:
        """Serve until the source closes and the engine drains (or SIGTERM).

        ``source`` yields, per tick: ``None`` (no arrivals), one
        :class:`Request`, or an iterable of them.  Exhaustion closes the
        stream; the daemon then ticks until idle.  Returns a run report.
        """
        src = iter(source)
        ticks = 0
        closed = False
        preempted = False
        drain_report: Optional[Dict[str, int]] = None
        guard = PreemptionGuard(signals=self.signals)
        with guard:
            while True:
                if guard.preempted:
                    preempted = True
                    break
                arrivals: List[Request] = []
                if not closed:
                    arrivals, closed = self._pull(src)
                    for req in arrivals:
                        self._submit(req)
                self.tick_monitor.start()
                report = self.engine.step()
                self.tick_monitor.stop(ticks)
                self._observe_slabs(report["slab_seconds"], ticks)
                ticks += 1
                if (
                    self.idle_sleep_s > 0
                    and not arrivals
                    and not report["slab_seconds"]
                    and report["admitted"] == 0
                    and report["blocking_served"] == 0
                ):
                    time.sleep(self.idle_sleep_s)
                if self.heartbeat is not None:
                    self.heartbeat.beat(ticks)
                if closed and self.engine.idle:
                    break
                if self.max_ticks is not None and ticks >= self.max_ticks:
                    closed = True
                    if self.engine.idle:
                        break
            if preempted:
                drain_report = self.engine.finish_in_flight(
                    reject_queued=not self.drain_queue_on_term
                )
                if self.heartbeat is not None:
                    self.heartbeat.beat(ticks)  # last beat: stale from here on
        return self.report(ticks, preempted, drain_report)

    # -- reporting ---------------------------------------------------------

    def report(
        self,
        ticks: int,
        preempted: bool,
        drain_report: Optional[Dict[str, int]] = None,
    ) -> Dict[str, Any]:
        lat = sorted(self._latencies)
        stats = self.engine.stats()
        return {
            "ticks": ticks,
            "preempted": preempted,
            "drain": drain_report,
            "completed": stats["completed"],
            "failed": stats["failed"],
            "rejected": stats["rejected"],
            "rejected_at_admission": self._rejected_at_admission,
            "stragglers": {
                "ticks": len(self.tick_monitor.events),
                "per_slab": {
                    label: len(m.events) for label, m in self.slab_monitors.items() if m.events
                },
            },
            "latency": {
                "count": len(lat),
                "mean_s": sum(lat) / len(lat) if lat else 0.0,
                "p50_s": percentile(lat, 50.0),
                "p99_s": percentile(lat, 99.0),
            },
            "stats": stats,
        }
