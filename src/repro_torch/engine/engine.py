"""The serving engine: ``submit(request) -> Future``, ``drain()``, ``stats()``
(the port of ``repro.engine.engine``).

One ``Engine`` owns a set of installed solver instances (built from the
:mod:`repro_torch.engine.registry` catalog), a pending-request queue per
(instance, shape bucket), a root ``torch.Generator`` from which every
request without its own key is given one, and a
:class:`repro_torch.engine.planner.Planner` that chops queues into batch
slabs and quotes latencies.

Lifecycle::

    eng = Engine(torch.Generator().manual_seed(0))           # serves on the GPU
    eng.install("letters", solver.as_engine_solver())         # a RetrievalSolver
    eng.install("cuts", "maxcut", sweeps=64, backend="kernel")
    futs = [eng.submit(Request("letters", corrupted)) for corrupted in stream]
    eng.drain()                                               # batch + execute
    results = [f.result() for f in futs]

Randomness: a request's ``key`` is a ``torch.Generator`` that its adapter
draws from exactly as the workload's isolated ``solve`` draws from the same
key, so a served request equals ``solver.solve(payload, key=<a generator
with the same seed>)`` under every bucket policy and occupancy.  A request
without a key gets a fresh generator on the engine's device, seeded by a
draw from the root generator, which lives on the CPU so that ``submit``
never waits on the card; two identical requests then anneal differently.

Every request is padded to a (batch, N) bucket
(:mod:`repro_torch.engine.bucketing`), so a stream of mixed-size requests
runs a bounded set of slab shapes.  Padded lanes are masked (zero couplings
/ dead batch rows) and never change results; see
``repro_torch.core.dynamics.pad_params`` for the bit-exactness argument.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import Any, Dict, Hashable, List, Optional, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core.checks import resolve_device
from repro_torch.engine import bucketing
from repro_torch.engine import registry as registry_lib
from repro_torch.engine.planner import Estimate, Planner

#: Seeds of per-request generators are drawn uniformly from [0, SEED_BOUND).
SEED_BOUND = 2**62


@runtime_checkable
class EngineSolver(Protocol):
    """What the engine needs from a servable workload adapter.

    Implementations batch *lanes*: a request payload carries one or more
    independent problem lanes (rows of a retrieval batch, one max-cut
    instance); the engine coalesces lanes from many requests into one
    padded slab and the adapter runs it through one batched solve,
    returning one result per request.
    """

    def lane_count(self, payload: Any) -> int:
        """Independent lanes in this payload (≥ 1)."""
        ...

    def signature(self, payload: Any) -> Hashable:
        """Natural shape signature of the payload (pre-bucketing)."""
        ...

    def bucket(self, signature: Hashable, n_policy: bucketing.NBucketPolicy) -> Hashable:
        """Padded shape signature this payload is served at."""
        ...

    def solve_bucket(
        self,
        bucket_sig: Hashable,
        payloads: List[Any],
        keys: List[torch.Generator],
        batch_bucket: int,
    ) -> List[Any]:
        """Serve ``payloads`` (Σ lanes ≤ batch_bucket) in one padded batch."""
        ...

    def cost_units(self, bucket_sig: Hashable, batch_bucket: int) -> float:
        """Abstract work units of one slab (for cold-start latency quotes)."""
        ...

    def fpga_seconds(self, bucket_sig: Hashable) -> Optional[float]:
        """Paper-hardware time-to-solution context, if the workload maps.

        Adapters may additionally expose ``fpga_tradeoff(bucket_sig)``
        returning a per-design quote mapping (recurrent vs hybrid at the
        configured parallel factor); the engine forwards it into
        :class:`repro_torch.engine.planner.Estimate` when present.
        """
        ...


class QueueFullError(RuntimeError):
    """Admission control rejected a request: the queue is at capacity.

    Raised by :meth:`Engine.submit` when accepting the request would push
    the pending lane count past ``max_queue_lanes`` (backpressure — the
    caller should retry later or shed load).  Nothing is enqueued.
    """


@dataclasses.dataclass(frozen=True, eq=False)
class Request:
    """One unit of submitted work.

    ``workload`` names an *installed* solver instance; ``payload`` is
    workload-specific; ``key`` optionally pins the request's randomness (a
    ``torch.Generator``, drawn from as the isolated solve draws from it);
    ``tenant`` identifies the submitter for per-tenant accounting (any
    string).
    """

    workload: str
    payload: Any
    key: Optional[torch.Generator] = None
    tenant: str = "default"


@dataclasses.dataclass(eq=False)
class _Pending:
    request: Request
    future: Future
    lanes: int
    key: torch.Generator
    estimate: Estimate


class Engine:
    """Async, shape-bucketed solver engine over the registered workloads.

    Parameters
    ----------
    generator:
        Root ``torch.Generator``, on the CPU.  A request without a key is
        given a fresh generator on ``device``, seeded by one draw from it
        (explicit: there is no hidden default seed on the serving path).
    device:
        Where per-request generators live: the GPU unless ``"cpu"`` (the
        port's device rule).  Adapters solve on the device of their own
        solver.
    batch_buckets:
        Allowed batch-slab sizes (sorted ascending).
    n_policy:
        Oscillator-count bucketing: ``"pow2"`` (default), ``"exact"``, or an
        explicit tuple of sizes.  See :mod:`repro_torch.engine.bucketing`.
    coalesce:
        Pack lanes from different requests into shared slabs (throughput).
        ``False`` serves each request in its own (padded) slab.
    auto_flush:
        Execute a bucket's queue from ``submit`` as soon as its pending
        lanes fill the largest batch bucket, bounding queue memory.
    max_queue_lanes:
        Admission-control bound: ``submit`` raises :class:`QueueFullError`
        once accepting a request would push the total pending lane count
        past this.  ``None`` (default) disables backpressure.
    """

    def __init__(
        self,
        generator: torch.Generator,
        *,
        device=None,
        batch_buckets: Tuple[int, ...] = bucketing.DEFAULT_BATCH_BUCKETS,
        n_policy: bucketing.NBucketPolicy = "pow2",
        coalesce: bool = True,
        auto_flush: bool = False,
        ema_alpha: float = 0.3,
        max_queue_lanes: Optional[int] = None,
    ) -> None:
        if not isinstance(generator, torch.Generator) or generator.device.type != "cpu":
            raise ValueError(
                "Engine needs a CPU torch.Generator as its root (seeds are drawn "
                "on the host, so submit never waits on the card)"
            )
        self._root = generator
        self.device = resolve_device(device)
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.n_policy = n_policy
        self.coalesce = coalesce
        self.auto_flush = auto_flush
        self.max_queue_lanes = max_queue_lanes
        self.planner = Planner(self.batch_buckets, ema_alpha=ema_alpha)
        self._solvers: Dict[str, EngineSolver] = {}
        self._queues: Dict[Tuple[str, Hashable], List[_Pending]] = {}
        self._counts = {
            "submitted": 0,
            "completed": 0,
            "failed": 0,
            "rejected": 0,
            "slabs": 0,
            "lanes_served": 0,
            "lanes_padding": 0,
        }
        self._tenants: Dict[str, Dict[str, int]] = {}
        self._bucket_log: Dict[Tuple[str, Hashable, int], int] = {}

    # -- installation ------------------------------------------------------

    def install(self, name: str, solver: Any = None, /, **kwargs: Any) -> EngineSolver:
        """Install a solver instance under ``name``.

        ``solver`` is a registry workload name (``"retrieval"``,
        ``"maxcut"``) whose factory receives ``kwargs``, or an already-built
        :class:`EngineSolver`.  Defaults to ``name`` itself, so
        ``install("maxcut", sweeps=64)`` works for the common case.  Both are
        positional, so a factory can take ``solver=``:
        ``install("mem", "retrieval", solver=retrieval_solver)``.
        """
        if name in self._solvers:
            raise ValueError(f"solver instance {name!r} already installed")
        if solver is None:
            solver = name
        if isinstance(solver, str):
            solver = registry_lib.solver_factory(solver)(**kwargs)
        elif kwargs:
            raise TypeError("kwargs only apply when building from the registry")
        if not isinstance(solver, EngineSolver):
            raise TypeError(f"{solver!r} does not implement EngineSolver")
        self._solvers[name] = solver
        return solver

    def solver(self, name: str) -> EngineSolver:
        try:
            return self._solvers[name]
        except KeyError:
            known = ", ".join(sorted(self._solvers)) or "<none>"
            raise KeyError(f"no installed solver {name!r} (installed: {known})") from None

    def hot_swap(self, name: str, params: Any) -> None:
        """Install freshly trained parameters into a live workload.

        Delegates to the solver's ``install_params`` (shape/range checked
        there); the solver keeps its config and launch plans.  The swap
        takes effect at the next flush: requests already queued are served
        with the *new* weights (drain first for a clean cut).
        """
        solver = self.solver(name)
        if not hasattr(solver, "install_params"):
            raise TypeError(f"workload {name!r} does not support hot weight install")
        solver.install_params(params)

    # -- submission --------------------------------------------------------

    def _next_key(self) -> torch.Generator:
        seed = int(torch.randint(SEED_BOUND, (), generator=self._root))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _tenant_counters(self, tenant: str) -> Dict[str, int]:
        return self._tenants.setdefault(
            tenant, {"submitted": 0, "completed": 0, "failed": 0, "rejected": 0}
        )

    def _queued_lanes(self) -> int:
        """Total pending lanes (admission control reads this)."""
        return sum(p.lanes for ps in self._queues.values() for p in ps)

    def _make_pending(
        self, request: Request
    ) -> Tuple[_Pending, Tuple[str, Hashable], int]:
        """Validate + bucket + quote + key one request (not enqueued)."""
        solver = self.solver(request.workload)
        lanes = solver.lane_count(request.payload)
        if lanes > self.batch_buckets[-1]:
            raise ValueError(
                f"request has {lanes} lanes > largest batch bucket "
                f"{self.batch_buckets[-1]}; split it or widen batch_buckets"
            )
        if request.key is not None and not isinstance(request.key, torch.Generator):
            raise TypeError(f"Request.key must be a torch.Generator, got {type(request.key).__name__}")
        sig = solver.signature(request.payload)
        bucket_sig = solver.bucket(sig, self.n_policy)
        qkey = (request.workload, bucket_sig)
        bb = bucketing.bucket_batch(lanes, self.batch_buckets)
        est = self.planner.estimate(
            (request.workload, bucket_sig, bb),
            units=solver.cost_units(bucket_sig, bb),
            fpga_seconds=solver.fpga_seconds(bucket_sig),
            fpga_tradeoff=self._fpga_tradeoff(solver, bucket_sig),
        )
        pending = _Pending(
            request=request,
            future=Future(),
            lanes=lanes,
            key=request.key if request.key is not None else self._next_key(),
            estimate=est,
        )
        return pending, qkey, lanes

    def _admit(self, request: Request, lanes: int) -> None:
        """Backpressure check; raises :class:`QueueFullError` on overflow."""
        if (
            self.max_queue_lanes is not None
            and self._queued_lanes() + lanes > self.max_queue_lanes
        ):
            self._counts["rejected"] += 1
            self._tenant_counters(request.tenant)["rejected"] += 1
            raise QueueFullError(
                f"queue full: {self._queued_lanes()} lanes pending + {lanes} "
                f"requested > max_queue_lanes={self.max_queue_lanes}"
            )

    def submit(self, request: Request) -> "Future[Any]":
        """Enqueue one request; returns a Future resolved at drain/flush.

        The request gets its generator (its own key, or a fresh one seeded
        from the root) and a latency estimate (readable via :meth:`stats`
        while pending).  Raises :class:`QueueFullError` when admission
        control rejects it.
        """
        pending, qkey, lanes = self._make_pending(request)
        self._admit(request, lanes)
        self._queues.setdefault(qkey, []).append(pending)
        self._counts["submitted"] += 1
        self._tenant_counters(request.tenant)["submitted"] += 1
        if self.auto_flush:
            if sum(p.lanes for p in self._queues[qkey]) >= self.batch_buckets[-1]:
                self._flush_queue(qkey)
        return pending.future

    # -- execution ---------------------------------------------------------

    def _pack(self, pendings: List[_Pending]) -> List[List[_Pending]]:
        """FIFO-pack pending requests into slabs of ≤ max batch bucket."""
        if not self.coalesce:
            return [[p] for p in pendings]
        cap = self.batch_buckets[-1]
        slabs: List[List[_Pending]] = []
        cur: List[_Pending] = []
        cur_lanes = 0
        for p in pendings:
            if cur and cur_lanes + p.lanes > cap:
                slabs.append(cur)
                cur, cur_lanes = [], 0
            cur.append(p)
            cur_lanes += p.lanes
        if cur:
            slabs.append(cur)
        return slabs

    def _run_slab(
        self, workload: str, bucket_sig: Hashable, slab: List[_Pending]
    ) -> None:
        solver = self._solvers[workload]
        lanes = sum(p.lanes for p in slab)
        bb = bucketing.bucket_batch(lanes, self.batch_buckets)
        t0 = time.perf_counter()
        try:
            results = solver.solve_bucket(
                bucket_sig, [p.request.payload for p in slab], [p.key for p in slab], bb
            )
        except Exception as exc:  # noqa: BLE001 — propagate through futures
            self._fail_slab(slab, exc)
            return
        seconds = time.perf_counter() - t0
        if len(results) != len(slab):
            self._fail_slab(
                slab,
                RuntimeError(
                    f"{workload}: solve_bucket returned {len(results)} results "
                    f"for {len(slab)} requests"
                ),
            )
            return
        self.planner.observe(
            (workload, bucket_sig, bb),
            seconds,
            units=solver.cost_units(bucket_sig, bb),
        )
        for p, r in zip(slab, results):
            p.future.set_result(r)
            self._tenant_counters(p.request.tenant)["completed"] += 1
        self._counts["completed"] += len(slab)
        self._counts["slabs"] += 1
        self._counts["lanes_served"] += bb
        self._counts["lanes_padding"] += bb - lanes
        lkey = (workload, bucket_sig, bb)
        self._bucket_log[lkey] = self._bucket_log.get(lkey, 0) + 1

    def _fail_slab(self, slab: List[_Pending], exc: BaseException) -> None:
        for p in slab:
            p.future.set_exception(exc)
            self._tenant_counters(p.request.tenant)["failed"] += 1
        self._counts["failed"] += len(slab)

    def _flush_queue(self, qkey: Tuple[str, Hashable]) -> int:
        pendings = self._queues.pop(qkey, [])
        if not pendings:
            return 0
        workload, bucket_sig = qkey
        for slab in self._pack(pendings):
            self._run_slab(workload, bucket_sig, slab)
        return len(pendings)

    def flush(self, workload: Optional[str] = None) -> int:
        """Execute pending queues (optionally only one workload's); returns
        the number of requests served."""
        served = 0
        for qkey in list(self._queues):
            if workload is None or qkey[0] == workload:
                served += self._flush_queue(qkey)
        return served

    def drain(self) -> Dict[str, Any]:
        """Serve everything pending; returns :meth:`stats` afterwards."""
        self.flush()
        return self.stats()

    # -- introspection -----------------------------------------------------

    @staticmethod
    def _fpga_tradeoff(solver: EngineSolver, bucket_sig: Hashable):
        """The adapter's per-design hardware quote mapping, when it has one."""
        tradeoff = getattr(solver, "fpga_tradeoff", None)
        return tradeoff(bucket_sig) if callable(tradeoff) else None

    def estimate(self, workload: str, payload: Any) -> Estimate:
        """Latency quote for a hypothetical request (nothing enqueued)."""
        solver = self.solver(workload)
        bucket_sig = solver.bucket(solver.signature(payload), self.n_policy)
        bb = bucketing.bucket_batch(solver.lane_count(payload), self.batch_buckets)
        return self.planner.estimate(
            (workload, bucket_sig, bb),
            units=solver.cost_units(bucket_sig, bb),
            fpga_seconds=solver.fpga_seconds(bucket_sig),
            fpga_tradeoff=self._fpga_tradeoff(solver, bucket_sig),
        )

    def stats(self) -> Dict[str, Any]:
        served = self._counts["lanes_served"]
        pending = {
            f"{w}:{b!r}": {
                "requests": len(ps),
                "lanes": sum(p.lanes for p in ps),
                "estimate_s": [round(p.estimate.seconds, 6) for p in ps],
            }
            for (w, b), ps in self._queues.items()
            if ps
        }
        return {
            **self._counts,
            "pad_fraction": 0.0 if served == 0 else self._counts["lanes_padding"] / served,
            "queue_depth": {
                "requests": sum(len(ps) for ps in self._queues.values()),
                "lanes": self._queued_lanes(),
            },
            "admission": {
                "max_queue_lanes": self.max_queue_lanes,
                "rejected": self._counts["rejected"],
            },
            "lane_occupancy": 0.0 if served == 0 else (
                (served - self._counts["lanes_padding"]) / served
            ),
            "tenants": {t: dict(c) for t, c in sorted(self._tenants.items())},
            "installed": sorted(self._solvers),
            # Workload-specific measurements, e.g. the retrieval adapter's
            # settle-cycle EMA (quotes tighten from max_cycles toward it).
            "solvers": {
                name: s.stats()
                for name, s in sorted(self._solvers.items())
                if hasattr(s, "stats")
            },
            "pending": pending,
            "slabs_per_bucket": {
                f"{w}:{b!r}:batch{bb}": c
                for (w, b, bb), c in sorted(self._bucket_log.items(), key=repr)
            },
            "planner": self.planner.snapshot(),
        }
