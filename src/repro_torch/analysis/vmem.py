"""The shared-memory, residency, grid and register budget of every launch plan.

The counterpart of ``repro.analysis.vmem``, which sizes the TPU kernels'
BlockSpecs against a 16 MiB VMEM.  The port has no VMEM: its planners
(:mod:`repro_torch.kernels.autotune`) size each launch against an H100's
shared memory, SMs and grid limits, and rest on assumptions about the
compiled kernels that no launch checks.  This module checks them in two
layers.

* **Static** (:func:`check_all`, no device, milliseconds).  For every bucket
  of :func:`~repro_torch.kernels.autotune.iter_buckets` it resolves the plans
  that the wrappers would make (``step``: ``coupling_plan(inst, b, n, n)``
  for inst 1, 16 and 32; ``hybrid``: P = 1, 32, 64 and N; ``matvec``:
  ``qmv_plan(b, n, n)``; ``multi``: ``multi_plan(b, n)``) through the
  planners' ``__wrapped__``, so that it neither fills nor counts in the
  caches that ``autotune.cache_info()`` reports.  Each plan is held to:

  - its shared memory, as the planner counts it, against the limit that
    applies less the static bytes the planner assumes outside that count:
    232,448 B with the opt-in (``autotune.SMEM_PER_BLOCK``), 49,152 B for
    kernel 8, which opts in to nothing;
  - the residency the planner assumes (two ``wide`` blocks of the coupling
    GEMM and two GEMV blocks of kernel 8 an SM, one block otherwise) in an
    SM's 233,472 B, each block with 1 KB reserved;
  - the grid's y and z against 65,535 (the coupling GEMM's y is its lane
    tiles, which passes it past about 4.19 M lanes on the wide tile;
    ``coupling_plan`` does not check that);
  - the cluster against the 8 CTAs that need no opt-in;
  - and it states the most registers a thread that the assumed residency
    allows: 65,536 / (threads × blocks), at most 255.

* **Compiled** (:func:`check_compiled`, on the card).  For each distinct
  instantiation that the static plans reach it asks the source's attribute
  entry (``ops.coupling_attributes``, ``multi_attributes``,
  ``qmv_attributes``: ``cudaFuncGetAttributes`` and
  ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` after the launch's
  opt-in, at the threads and shared memory of the source's own launch code)
  and holds it to what the planner assumed: its static shared memory (0 for
  the coupling GEMM and kernel 5's cluster regime, at most
  ``MULTI_STATIC_SMEM`` for the stream regime, ``QMV_GEMM_SMEM`` and
  ``QMV_FLAG_SMEM`` for kernel 8), the plan's threads (``plan.threads``)
  against the launch's block size and the compiled most threads a block, and
  its
  residency (for kernel 5's cluster regime, ``ops.multi_cluster_occupancy``
  ≥ 1 for every cluster plan).  Local bytes (spills) are reported.  A miss
  of a constant is a fault (:attr:`CompiledReport.constants_ok`); a miss of a
  residency is reported with the occupancy measured.

``python -m repro_torch.analysis --vmem`` runs both layers (static only with
``--device cpu``).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Iterable, Iterator, List, Optional, TextIO, Tuple

from repro_torch.kernels import autotune

#: Shared memory an SM holds, and what it reserves for each resident block.
SMEM_PER_SM = autotune.SMEM_PER_SM
BLOCK_RESERVED = 1024
#: Shared memory a block may use without an opt-in (kernel 8 stays within it).
STATIC_LIMIT = autotune.QMV_STATIC_SMEM
#: CUDA's limits on the grid's y and z, and the most CTAs a cluster has
#: without the non-portable opt-in.
MAX_GRID_YZ = 65_535
MAX_GRID_X = 2**31 - 1
PORTABLE_CLUSTER = 8
#: Registers of one SM, and the most one thread may have.
REGISTERS_PER_SM = 65_536
MAX_REGISTERS = 255
#: What the ``step`` and ``hybrid`` buckets plan: the instance counts of
#: kernels 1-4 (one W) and of the instance axis, and the hybrid MAC widths
#: beside P = N.
STEP_INSTANCES = (1, 16, 32)
HYBRID_WIDTHS = (1, 32, 64)
#: The coupling GEMM's entries (``ops.GEMM_MODES``) that each kind launches.
STEP_MODES = ("coupling_sum", "onn_step", "phase_step", "phase_step_packed")
HYBRID_MODES = ("coupling_sum", "phase_step")


@dataclasses.dataclass(frozen=True)
class PlanReport:
    """One launch plan held to the card's limits.

    ``smem`` is the shared memory of one block as the planner counts it;
    ``static`` the static bytes the planner assumes outside that count;
    ``limit`` the shared memory a block may use (with the opt-in, or
    without); ``blocks_per_sm`` the residency the planner assumes."""

    kernel: str
    plan: str
    smem: int
    static: int
    limit: int
    threads: int
    blocks_per_sm: int
    grid: Tuple[int, int, int]
    cluster: int = 1

    @property
    def budget(self) -> int:
        return self.limit - self.static

    @property
    def sm_bytes(self) -> int:
        """Shared memory of an SM at the assumed residency."""
        return self.blocks_per_sm * (self.smem + self.static + BLOCK_RESERVED)

    @property
    def max_registers(self) -> int:
        """The most registers a thread that the assumed residency allows."""
        return min(MAX_REGISTERS, REGISTERS_PER_SM // (self.threads * self.blocks_per_sm))

    def problems(self) -> List[str]:
        out = []
        if self.smem > self.budget:
            out.append(f"shared memory {self.smem:,d} > {self.budget:,d} B")
        if self.sm_bytes > SMEM_PER_SM:
            out.append(f"{self.blocks_per_sm} blocks need {self.sm_bytes:,d} > "
                       f"{SMEM_PER_SM:,d} B of an SM")
        gx, gy, gz = self.grid
        if gx > MAX_GRID_X or gy > MAX_GRID_YZ or gz > MAX_GRID_YZ:
            out.append(f"grid {self.grid} past CUDA's limits")
        if self.cluster > PORTABLE_CLUSTER:
            out.append(f"cluster of {self.cluster} > {PORTABLE_CLUSTER} CTAs")
        return out

    @property
    def ok(self) -> bool:
        return not self.problems()

    @property
    def ratio(self) -> float:
        return self.smem / self.budget

    def render(self) -> str:
        status = "ok" if self.ok else "OVER: " + "; ".join(self.problems())
        return (f"{self.kernel:26s} {self.plan:34s} {self.smem:>9,d} / {self.budget:>9,d} B "
                f"x{self.blocks_per_sm} grid={self.grid} regs<={self.max_registers}  {status}")


@dataclasses.dataclass(frozen=True)
class BucketReport:
    """Every plan of one ``(kind, n, batch)`` bucket; ``refused`` holds a
    planner's refusal (a bucket it cannot plan is a failure)."""

    kind: str
    n: int
    batch: int
    plans: Tuple[PlanReport, ...]
    refused: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.refused is None and all(p.ok for p in self.plans)

    def render(self) -> str:
        head = f"{self.kind:7s} n={self.n:<6d} b={self.batch:<5d}"
        if self.refused is not None:
            return f"{head} REFUSED: {self.refused}"
        return "\n".join(f"{head} {p.render()}" for p in self.plans if not p.ok)


# ---------------------------------------------------------------------------
# The plans of a bucket
# ---------------------------------------------------------------------------


def _coupling(plan: autotune.CouplingPlan) -> PlanReport:
    tile = plan.tile
    return PlanReport(
        kernel=f"coupling_gemm/{tile.name}",
        plan=f"inst={plan.inst} P={plan.parallel} span={plan.span}",
        smem=plan.smem_bytes, static=0, limit=autotune.SMEM_PER_BLOCK,
        threads=plan.threads, blocks_per_sm=2 if tile.name == "wide" else 1, grid=plan.grid,
    )


def _multi(plan: autotune.MultiPlan) -> PlanReport:
    if plan.regime == "cluster":
        return PlanReport(
            kernel="phase_step_multi/cluster",
            plan=f"C={plan.cluster} L={plan.lanes} R={plan.rows}",
            smem=plan.smem_bytes, static=0, limit=autotune.SMEM_PER_BLOCK,
            threads=plan.threads, blocks_per_sm=1, grid=(plan.grid, 1, 1),
            cluster=plan.cluster,
        )
    return PlanReport(
        kernel="phase_step_multi/stream", plan=f"lanes={plan.lanes}",
        smem=plan.smem_bytes, static=autotune.MULTI_STATIC_SMEM, limit=autotune.SMEM_PER_BLOCK,
        threads=plan.threads, blocks_per_sm=1, grid=(plan.grid, 1, 1),
    )


def _qmv(plan: autotune.QmvPlan) -> PlanReport:
    gemv = plan.regime == "gemv"
    return PlanReport(
        kernel=f"quantized_matvec/{plan.regime}",
        plan=(f"lanes={plan.lanes} " if gemv else "") + f"k_chunk={plan.k_chunk} "
             f"splits={plan.splits}",
        smem=plan.smem_bytes, static=0, limit=STATIC_LIMIT,
        threads=plan.threads, blocks_per_sm=2 if gemv else 1, grid=plan.grid,
    )


def bucket_plans(kind: str, n: int, batch: int) -> Iterator[Tuple[object, Tuple[str, ...]]]:
    """The plans the wrappers make for one bucket, uncached, each with the
    coupling GEMM entries that launch it (empty for kernels 5 and 8)."""
    if kind == "step":
        for inst in STEP_INSTANCES:
            plan = autotune.coupling_plan.__wrapped__(inst, batch, n, n)
            yield plan, STEP_MODES if inst == 1 else ("coupling_sum",)
    elif kind == "hybrid":
        for p in (*HYBRID_WIDTHS, n):
            yield autotune.coupling_plan.__wrapped__(1, batch, n, n, p), HYBRID_MODES
    elif kind == "matvec":
        yield autotune.qmv_plan(batch, n, n), ()
    elif kind == "multi":
        yield autotune.multi_plan.__wrapped__(batch, n), ()
    else:
        raise ValueError(f"unknown autotune kind {kind!r}; expected one of {autotune.KINDS}")


def plan_report(plan: object) -> PlanReport:
    if isinstance(plan, autotune.CouplingPlan):
        return _coupling(plan)
    if isinstance(plan, autotune.MultiPlan):
        return _multi(plan)
    return _qmv(plan)


def check_bucket(kind: str, n: int, batch: int) -> BucketReport:
    """Resolve one bucket's plans and hold each to the card's limits."""
    try:
        plans = tuple(plan_report(p) for p, _ in bucket_plans(kind, n, batch))
    except ValueError as exc:
        return BucketReport(kind, n, batch, (), refused=str(exc))
    return BucketReport(kind, n, batch, plans)


def check_all(kinds: Tuple[str, ...] = autotune.KINDS) -> List[BucketReport]:
    """One :class:`BucketReport` per ``iter_buckets`` bucket; the planners'
    caches are neither filled nor counted."""
    return [check_bucket(kind, n, batch) for kind, n, batch in autotune.iter_buckets(kinds)]


def tightest(reports: Iterable[BucketReport]) -> List[Tuple[BucketReport, PlanReport]]:
    """The tightest plan of each kernel, tightest first (ties: the first bucket)."""
    best: Dict[str, Tuple[BucketReport, PlanReport]] = {}
    for r in reports:
        for p in r.plans:
            if p.kernel not in best or p.ratio > best[p.kernel][1].ratio:
                best[p.kernel] = (r, p)
    return sorted(best.values(), key=lambda rp: -rp[1].ratio)


def report(out: TextIO = sys.stdout, reports: Iterable[BucketReport] | None = None) -> int:
    """Print the failing buckets and a summary with each kernel's tightest
    plan; return the failure count."""
    reports = list(check_all() if reports is None else reports)
    failures = [r for r in reports if not r.ok]
    for r in failures:
        out.write(r.render() + "\n")
    plans = sum(len(r.plans) for r in reports)
    out.write(f"vmem: {len(reports)} buckets, {plans} plans checked, {len(failures)} over "
              f"budget or refused; tightest plan of each kernel:\n")
    for r, p in tightest(reports):
        out.write(f"  {100.0 * p.ratio:5.1f}% {r.kind:7s} n={r.n:<6d} b={r.batch:<5d} "
                  f"{p.render()}\n")
    return len(failures)


# ---------------------------------------------------------------------------
# The compiled instantiations, on the card
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompiledReport:
    """One compiled instantiation against what its planner assumed.

    ``configs``: the distinct launch configurations of it that the static
    plans reach; ``threads``: the most threads a block that its plans
    state (``plan.threads``), and ``threads_match`` whether each of them is
    the block size that the source's launch uses;
    ``blocks_per_sm``: the least occupancy measured over them, against
    ``assumed_blocks``; ``clusters``: for kernel 5's cluster regime, the
    least ``multi_cluster_occupancy`` over its cluster plans."""

    kernel: str
    configs: int
    registers: int
    local_bytes: int
    static_smem: int
    expected_static: str
    static_ok: bool
    max_threads: int
    threads: int
    threads_match: bool
    blocks_per_sm: int
    assumed_blocks: int
    clusters: Optional[int] = None

    @property
    def threads_ok(self) -> bool:
        return self.threads_match and self.max_threads >= self.threads

    @property
    def constants_ok(self) -> bool:
        """The static shared memory and the threads a planner relies on."""
        return self.static_ok and self.threads_ok

    @property
    def residency_ok(self) -> bool:
        if self.clusters is not None:
            return self.clusters >= 1
        return self.blocks_per_sm >= self.assumed_blocks

    @property
    def ok(self) -> bool:
        return self.constants_ok and self.residency_ok

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self), "threads_ok": self.threads_ok,
                "constants_ok": self.constants_ok, "residency_ok": self.residency_ok,
                "ok": self.ok}

    def render(self) -> str:
        res = (f"clusters>={self.clusters}" if self.clusters is not None
               else f"blocks/SM {self.blocks_per_sm} (assumed {self.assumed_blocks})")
        return (f"{self.kernel:44s} regs {self.registers:3d} local {self.local_bytes:4d} B "
                f"static {self.static_smem:6,d} B ({self.expected_static}) threads "
                f"{self.threads}{'' if self.threads_match else ' (not the launch)'}/"
                f"{self.max_threads} {res}  "
                f"{'ok' if self.ok else 'MISS' if not self.constants_ok else 'RESIDENCY'}")


def _instantiations(plan: object, modes: Tuple[str, ...]) -> Iterator[Tuple[str, tuple]]:
    """(instantiation name, query) for each compiled kernel a plan launches;
    a query is (kind, plan, mode or packed)."""
    if isinstance(plan, autotune.CouplingPlan):
        for mode in modes:
            yield f"coupling_gemm<{mode},{plan.tile.name}>", ("gemm", plan, mode)
    elif isinstance(plan, autotune.MultiPlan):
        size = "L" if plan.regime == "cluster" else "BB"
        for packed in (False, True):
            name = f"phase_step_multi<{'packed' if packed else 'unpacked'},{plan.regime}," \
                   f"{size}={plan.lanes}>"
            yield name, ("multi", plan, packed)
    else:
        vec = "vector" if plan.vector else "scalar"
        lanes = f",NB={plan.lanes}" if plan.regime == "gemv" else ""
        yield f"quantized_matvec<{plan.regime}{lanes},{vec}>", ("qmv", plan, None)


def _launch_config(query: tuple) -> tuple:
    """What the occupancy of a query depends on beyond its instantiation."""
    kind, plan, _ = query
    if kind == "gemm":
        return (plan.tile.index,)
    if kind == "multi":
        return plan.args
    return (plan.smem_bytes,)


def _expected_static(kernel: str) -> Tuple[str, int, bool]:
    """(rule, bound, exact) of an instantiation's static shared memory."""
    if kernel.startswith("quantized_matvec<gemm"):
        return f"== QMV_GEMM_SMEM {autotune.QMV_GEMM_SMEM:,d}", autotune.QMV_GEMM_SMEM, True
    if kernel.startswith("quantized_matvec<gemv"):
        return f"== QMV_FLAG_SMEM {autotune.QMV_FLAG_SMEM}", autotune.QMV_FLAG_SMEM, True
    if ",stream," in kernel:
        return f"<= MULTI_STATIC_SMEM {autotune.MULTI_STATIC_SMEM:,d}", \
            autotune.MULTI_STATIC_SMEM, False
    return "== 0", 0, True


def check_compiled(device=None) -> List[CompiledReport]:
    """Every instantiation the static plans reach, as compiled on ``device``
    (the GPU unless given; raises without one: the compiled kernels exist
    only on the card)."""
    import torch

    from repro_torch.core.checks import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"check_compiled reads the kernels compiled for the card, not {dev}")
    queries: Dict[str, Dict[tuple, tuple]] = {}
    for kind, n, batch in autotune.iter_buckets():
        try:
            plans = list(bucket_plans(kind, n, batch))
        except ValueError:
            continue  # the static layer reports the refusal
        for plan, modes in plans:
            for name, query in _instantiations(plan, modes):
                queries.setdefault(name, {}).setdefault(_launch_config(query), query)
    out = []
    with torch.cuda.device(dev):
        for name in sorted(queries):
            attrs, clusters, match = [], None, True
            for kind, plan, arg in queries[name].values():
                if kind == "gemm":
                    attrs.append(ops.coupling_attributes(plan, arg))
                elif kind == "multi":
                    attrs.append(ops.multi_attributes(plan, arg))
                    if plan.regime == "cluster":
                        held = ops.multi_cluster_occupancy(plan, arg)
                        clusters = held if clusters is None else min(clusters, held)
                else:
                    attrs.append(ops.qmv_attributes(plan))
                match = match and attrs[-1]["threads"] == plan.threads
            first = attrs[0]
            threads = max(plan.threads for _, plan, _ in queries[name].values())
            rule, bound, exact = _expected_static(name)
            static = first["static_smem"]
            assumed = 2 if (",wide>" in name or "<gemv" in name) else 1
            out.append(CompiledReport(
                kernel=name, configs=len(attrs), registers=first["registers"],
                local_bytes=first["local_bytes"], static_smem=static, expected_static=rule,
                static_ok=static == bound if exact else static <= bound,
                max_threads=first["max_threads"], threads=threads, threads_match=match,
                blocks_per_sm=min(a["blocks_per_sm"] for a in attrs), assumed_blocks=assumed,
                clusters=clusters,
            ))
    return out


def report_compiled(out: TextIO = sys.stdout, device=None) -> int:
    """Print one line per compiled instantiation; return the count of
    instantiations that miss a constant a planner relies on (a residency
    miss is printed, not counted)."""
    rows = check_compiled(device)
    for r in rows:
        out.write(r.render() + "\n")
    misses = sum(not r.constants_ok for r in rows)
    out.write(f"vmem: {len(rows)} compiled instantiations, {misses} miss a constant, "
              f"{sum(not r.residency_ok for r in rows)} below the assumed residency\n")
    return misses
