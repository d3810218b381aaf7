"""Continuous-batching scheduler: freed lanes backfill mid-solve (the port of
``repro.serving.scheduler``).

:class:`ContinuousEngine` extends :class:`repro_torch.engine.engine.Engine` with a
ticked serving loop.  Streaming workloads (adapters exposing the slab
protocol — ``begin_slab``/``admit``/``advance``/``done_mask``/``results``/
``extract``) keep one live slab per shape bucket; every :meth:`step`
advances each slab by one settle-chunk, harvests lanes that froze (early
exit), and installs queued requests of the same bucket signature into the
freed slots at the chunk boundary.  Per-lane clocks in the core
(:class:`repro_torch.core.dynamics.BatchState`) make a mid-flight join
bit-exact with solving the request in isolation.  Each tick waits on the
card once per live slab, when the harvest reads its done mask; nothing
waits per request.

Workloads without the slab protocol (max-cut, LM decode) still serve
through the blocking ``solve_bucket`` path, one slab per tick, so one
daemon serves mixed traffic.  All queues are per-tenant weighted fair
queues (:class:`repro_torch.serving.admission.FairQueues`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Hashable, List, Optional, Tuple

import torch

from repro_torch.engine import bucketing
from repro_torch.engine.engine import Engine, Request, _Pending
from repro_torch.kernels import autotune
from repro_torch.serving.admission import FairQueues


class DrainRejectedError(RuntimeError):
    """The daemon shut down before this queued request was scheduled.

    Set on the futures of still-queued requests when a preemption drain
    runs with ``reject_queued=True`` (in-flight lanes complete; queued work
    is shed so shutdown is bounded by one slab, not the backlog).
    """


@dataclasses.dataclass(eq=False)  # identity eq: entries.remove() must never
class _SlabEntry:  # field-compare payload arrays (ambiguous elementwise bool)
    pending: _Pending
    slots: List[int]


@dataclasses.dataclass
class _SlabRecord:
    slab: Any  # adapter slab handle (e.g. RetrievalSlab)
    width: int
    entries: List[_SlabEntry] = dataclasses.field(default_factory=list)
    free: List[int] = dataclasses.field(default_factory=list)
    advanced: bool = False  # has run ≥ 1 chunk (joins after this are mid-flight)
    pending_resize: bool = False  # a queued request needs a wider slab: drain


class ContinuousEngine(Engine):
    """Engine with a continuous-batching tick loop and tenant fairness.

    Parameters (beyond :class:`Engine`)
    -----------------------------------
    generator / device:
        As :class:`Engine`: the CPU root ``torch.Generator`` and the device
        of per-request generators (the GPU unless ``"cpu"``).
    slab_lanes:
        Lane capacity of one streaming slab (clamped to the largest batch
        bucket).  Queued lanes beyond it wait and flow into freed slots —
        the batch-bucket chop under continuous load.
    tenant_weights:
        Relative fair-share weights per tenant id (unknown tenants get 1).
    """

    def __init__(
        self,
        generator: torch.Generator,
        *,
        device=None,
        slab_lanes: Optional[int] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("auto_flush", False)
        if kwargs["auto_flush"]:
            raise ValueError("ContinuousEngine schedules via step(); auto_flush must be off")
        super().__init__(generator, device=device, **kwargs)
        cap = self.batch_buckets[-1]
        self.slab_lanes = cap if slab_lanes is None else max(1, min(slab_lanes, cap))
        self._fair = FairQueues(tenant_weights)
        self._slabs: Dict[Tuple[str, Hashable], _SlabRecord] = {}
        self._serving_counts = {
            "ticks": 0,
            "chunks": 0,
            "mid_flight_joins": 0,
            "slabs_opened": 0,
            "slabs_retired": 0,
            "drain_rejected": 0,
            "hot_swaps": 0,
        }

    # -- submission --------------------------------------------------------

    def submit(self, request: Request) -> Any:
        """Enqueue into the fair queues; served by :meth:`step` ticks."""
        pending, qkey, lanes = self._make_pending(request)
        self._admit(request, lanes)
        self._fair.push(request.tenant, qkey, pending, lanes)
        self._counts["submitted"] += 1
        self._tenant_counters(request.tenant)["submitted"] += 1
        return pending.future

    def _queued_lanes(self) -> int:
        return super()._queued_lanes() + self._fair.queued_lanes()

    # -- the tick ----------------------------------------------------------

    def _is_streaming(self, workload: str) -> bool:
        return hasattr(self._solvers[workload], "begin_slab")

    def _slab_width(self, qkey: Tuple[str, Hashable]) -> int:
        """Bucketed width for a new slab: the configured lane budget, widened
        only when a queued request needs more slots.

        Deliberately NOT sized to the momentary queue: a sticky width means
        one kernel launch plan per (config, N bucket) for the whole run.
        Idle lanes are dead (frozen at birth) and cost only masked work.
        """
        widest = self._fair.max_request_lanes(qkey)
        return bucketing.bucket_batch(max(self.slab_lanes, widest, 1), self.batch_buckets)

    def _backfill(self, qkey: Tuple[str, Hashable], rec: _SlabRecord) -> Tuple[int, int]:
        """Install queued requests into free slots; returns (admitted, joins)."""
        workload, _ = qkey
        solver = self._solvers[workload]
        admitted = joins = 0
        if self._fair.max_request_lanes(qkey) > rec.width:
            # A queued request can never fit this slab: stop admitting and
            # let it drain, then _ensure_slab reopens at the wider bucket.
            rec.pending_resize = True
        if rec.pending_resize:
            return 0, 0
        while rec.free:
            nxt = self._fair.pop(qkey, max_lanes=len(rec.free))
            if nxt is None:
                break
            _, pending, lanes = nxt
            slots = [rec.free.pop(0) for _ in range(lanes)]
            solver.admit(rec.slab, slots, pending.request.payload, pending.key)
            rec.entries.append(_SlabEntry(pending, slots))
            admitted += 1
            if rec.advanced:
                joins += 1
        return admitted, joins

    def _ensure_slab(self, qkey: Tuple[str, Hashable]) -> Optional[_SlabRecord]:
        rec = self._slabs.get(qkey)
        if rec is None and self._fair.queued_lanes(qkey) > 0:
            workload, bucket_sig = qkey
            width = self._slab_width(qkey)
            rec = _SlabRecord(
                slab=self._solvers[workload].begin_slab(bucket_sig, width),
                width=width,
                free=list(range(width)),
            )
            self._slabs[qkey] = rec
            self._serving_counts["slabs_opened"] += 1
        return rec

    def _harvest(self, qkey: Tuple[str, Hashable], rec: _SlabRecord) -> int:
        """Resolve futures of requests whose lanes all froze; free the slots."""
        workload, bucket_sig = qkey
        solver = self._solvers[workload]
        mask = solver.done_mask(rec.slab)
        done = [e for e in rec.entries if all(bool(mask[s]) for s in e.slots)]
        if not done:
            return 0
        res = solver.results(rec.slab)
        done_slots: List[int] = []
        for e in done:
            e.pending.future.set_result(
                solver.extract(res, e.slots, e.pending.request.payload)
            )
            self._counts["completed"] += 1
            self._tenant_counters(e.pending.request.tenant)["completed"] += 1
            rec.entries.remove(e)
            rec.free.extend(e.slots)
            done_slots.extend(e.slots)
        if hasattr(solver, "observe"):
            solver.observe(res, done_slots)
        self._counts["lanes_served"] += len(done_slots)
        return len(done)

    def step(self, admit: bool = True) -> Dict[str, Any]:
        """One scheduler tick: backfill, advance one chunk, harvest.

        ``admit=False`` freezes admission (drain mode): live slabs keep
        advancing but freed slots are not refilled.  Returns a report with
        per-slab advance seconds for latency anomaly detection.
        """
        self._serving_counts["ticks"] += 1
        report: Dict[str, Any] = {
            "admitted": 0,
            "mid_flight_joins": 0,
            "harvested": 0,
            "blocking_served": 0,
            "slab_seconds": {},
        }
        if admit:
            for qkey in self._fair.qkeys():
                workload, bucket_sig = qkey
                if self._is_streaming(workload):
                    rec = self._ensure_slab(qkey)
                    if rec is not None:
                        a, j = self._backfill(qkey, rec)
                        report["admitted"] += a
                        report["mid_flight_joins"] += j
                        self._serving_counts["mid_flight_joins"] += j
                else:
                    # Blocking workloads run whole slabs inside one tick.
                    popped = self._fair.pop_all(qkey)
                    pendings = [p for _, p, _ in popped]
                    for slab in self._pack(pendings):
                        self._run_slab(workload, bucket_sig, slab)
                    report["blocking_served"] += len(pendings)

        for qkey, rec in list(self._slabs.items()):
            workload, bucket_sig = qkey
            solver = self._solvers[workload]
            if rec.entries:
                t0 = time.perf_counter()
                solver.advance(rec.slab)
                harvested = self._harvest(qkey, rec)  # syncs on done_mask
                dt = time.perf_counter() - t0
                rec.advanced = True
                self._serving_counts["chunks"] += 1
                report["harvested"] += harvested
                report["slab_seconds"][f"{workload}:{bucket_sig!r}"] = dt
            if not rec.entries and (
                rec.pending_resize or self._fair.queued_lanes(qkey) == 0
            ):
                del self._slabs[qkey]
                self._serving_counts["slabs_retired"] += 1
        return report

    # -- hot weight install ------------------------------------------------

    def hot_swap(self, name: str, params: Any) -> None:
        """Install new weights into workload ``name`` at a chunk boundary.

        Called between ticks (the scheduler is single-threaded, so any call
        site is a settle-chunk boundary).  The solver's cached padded params
        are replaced immediately — every slab opened from now on runs the
        new weights — but live slabs are only *marked to drain*: a
        ``RetrievalSlab`` snapshots its params at ``begin_slab``, so
        in-flight lanes finish on the weights they started with, freed
        slots stop backfilling, and once the slab empties it retires and a
        fresh one opens on the new weights.  Post-swap submissions are
        therefore bit-exact with a cold restart on the new weights, and
        pre-swap submissions admitted before the swap with the old — no lane
        ever sees a weight change mid-trajectory.
        """
        super().hot_swap(name, params)
        for (workload, _), rec in self._slabs.items():
            if workload == name:
                # Same drain-then-reopen path as a slab resize.
                rec.pending_resize = True
        self._serving_counts["hot_swaps"] += 1

    # -- lifecycle ---------------------------------------------------------

    @property
    def idle(self) -> bool:
        """No queued work and no live slab lanes."""
        return (
            self._fair.request_count() == 0
            and not any(rec.entries for rec in self._slabs.values())
            and not any(self._queues.values())
        )

    def flush(self, workload: Optional[str] = None) -> int:
        """Tick until idle (the ``workload`` filter of the one-shot engine
        does not apply to the shared continuous loop); returns requests
        served."""
        before = self._counts["completed"]
        while not self.idle:
            self.step()
        return self._counts["completed"] - before

    def finish_in_flight(self, reject_queued: bool = True) -> Dict[str, int]:
        """Bounded drain for preemption: complete in-flight lanes only.

        Queued (not yet scheduled) requests get :class:`DrainRejectedError`
        on their futures when ``reject_queued`` (otherwise they are served
        normally, equivalent to :meth:`flush`).  Returns counts.
        """
        rejected = 0
        if reject_queued:
            for pending in self._fair.drain_items():
                pending.future.set_exception(
                    DrainRejectedError("daemon draining: request was never scheduled")
                )
                self._counts["rejected"] += 1
                self._tenant_counters(pending.request.tenant)["rejected"] += 1
                rejected += 1
            self._serving_counts["drain_rejected"] += rejected
            completed = 0
            while any(rec.entries for rec in self._slabs.values()):
                completed += self.step(admit=False)["harvested"]
            return {"rejected": rejected, "completed": completed}
        served = self.flush()
        return {"rejected": 0, "completed": served}

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out["queue_depth"]["requests"] += self._fair.request_count()
        live = sum(len(rec.entries) for rec in self._slabs.values())
        lanes_live = sum(
            len(e.slots) for rec in self._slabs.values() for e in rec.entries
        )
        width = sum(rec.width for rec in self._slabs.values())
        out["serving"] = {
            **self._serving_counts,
            "slab_lanes": self.slab_lanes,
            "slabs_active": len(self._slabs),
            "requests_in_flight": live,
            "lanes_in_flight": lanes_live,
            "slab_occupancy": 0.0 if width == 0 else lanes_live / width,
            "queued_by_tenant": self._fair.depths(),
            "autotune": autotune.cache_info(),
        }
        return out
