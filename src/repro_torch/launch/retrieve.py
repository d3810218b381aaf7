"""ONN pattern-retrieval CLI: a thin adapter over the ``repro_torch.engine``
engine (the port of ``repro.launch.retrieve``).

Trains Diederich–Opper I coupling weights for a letter dataset into a
``repro_torch.api.RetrievalSolver``, installs it on a serving engine, and
submits each corrupted pattern as one request.  The engine coalesces
request lanes into shape-bucketed slabs — padded lanes are masked and equal
to unpadded solves — and the drained results are aggregated into the
paper's Fig. 7 accuracy/settle statistics.

One CPU ``torch.Generator`` seeded by ``--seed`` draws which pattern each
request corrupts and which pixels it flips (:func:`draw_requests`), then
roots the engine (:func:`serve_corrupted`).  Bucket solves are one call into
the batched ``retrieve``: ``--backend kernel`` runs each settle-chunk
(``--settle-chunk`` cycles) as one launch of the multi-cycle kernel,
``--backend hybrid --hybrid-impl kernel`` one hybrid phase-step launch per
cycle, and ``--mode rtl`` steps clock by clock.  It runs on the card unless
``--device cpu``.

``--mesh BxM`` activates a :class:`repro_torch.distributed.ShardPlan` —
B-way data-parallel lanes × M-way row-sharded coupling matrix (``auto``
asks ``ft.propose_mesh``) over the real local devices (the CUDA cards, or
the one CPU); the legacy ``--shard-batch`` recipe still works as a
deprecated alias for an all-data mesh.  A mesh that repeats one device
(``make_mesh(devices=["cpu"] * 8)``) is passed to :func:`serve_requests`
as ``mesh=``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.retrieve --dataset 22x22 \\
      --corruption 0.25 --requests 1024 --backend kernel
  PYTHONPATH=src python -m repro_torch.launch.retrieve --device cpu --dataset 5x4 --requests 32
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import RetrievalSolver
from repro_torch.core.dynamics import ONNResult
from repro_torch.data import patterns as pat
from repro_torch.distributed import Mesh, ShardPlan, make_mesh, plan_of_legacy_shard_batch
from repro_torch.distributed import sharding as shard_lib
from repro_torch.distributed.plan import local_device_count
from repro_torch.engine import DEFAULT_BATCH_BUCKETS, Engine, Request
from repro_torch.launch import mesh as mesh_lib


def build_solver(
    dataset: str,
    architecture: str = "hybrid",
    mode: str = "functional",
    weight_bits: int = 5,
    phase_bits: int = 4,
    max_cycles: int = 100,
    backend: str = "parallel",
    settle_chunk: int = 8,
    parallel_factor: int = 0,
    hybrid_impl: str = "scan",
    device=None,
) -> Tuple[RetrievalSolver, torch.Tensor]:
    """Train a solver for one letter dataset on ``device`` (the GPU unless
    ``"cpu"``); returns (solver, patterns), both there."""
    xi = pat.load_dataset(dataset, device=device)  # (P, N) ±1
    solver = RetrievalSolver.from_patterns(
        xi,
        weight_bits=weight_bits,
        device=device,
        phase_bits=phase_bits,
        architecture=architecture,
        mode=mode,
        max_cycles=max_cycles,
        backend=backend,
        settle_chunk=settle_chunk,
        parallel_factor=parallel_factor,
        hybrid_impl=hybrid_impl,
    )
    return solver, xi


def draw_requests(
    xi: torch.Tensor, corruption: float, n_requests: int, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(which, corrupted): request i corrupts pattern ``which[i]`` of ``xi``
    (P, N) with ``round(corruption · N)`` pixels flipped.  Both come from the
    CPU ``generator``: ``torch.randint`` for ``which``, then one
    ``patterns.corrupt`` per request.  Both are on the CPU."""
    patterns = xi.cpu()
    which = torch.randint(0, patterns.shape[0], (n_requests,), generator=generator)
    corrupted = torch.stack(
        [pat.corrupt(patterns[int(w)], corruption, generator=generator) for w in which]
    )
    return which, corrupted


def batch_mesh() -> Optional[Mesh]:
    """Deprecated: a ``("data", "model")`` mesh over all local cards,
    data-major ``(n, 1)``.

    The old per-launcher sharded-retrieve recipe (lanes over every device,
    coupling matrix replicated).  Superseded by
    :class:`repro_torch.distributed.ShardPlan` — ``plan_of_legacy_shard_batch()``
    is the equivalent plan, and ``--mesh BxM`` composes data- and
    model-parallelism.  Returns None on fewer than two devices.
    """
    n = local_device_count()
    if n < 2:
        return None
    return make_mesh((n, 1))


def plan_mesh(plan: Optional[ShardPlan], mesh: Optional[Mesh], device) -> Optional[Mesh]:
    """The mesh to serve ``plan`` on: ``mesh``, else the plan's mesh over the
    local devices of ``device``'s type; None for no plan or a 1×1 plan."""
    if plan is None or plan.devices == 1:
        return None
    return plan.make_mesh(device=device) if mesh is None else mesh


def plan_scope(plan: Optional[ShardPlan], mesh: Optional[Mesh]):
    """The context that activates ``plan`` on ``mesh`` (a no-op without one)."""
    return contextlib.nullcontext() if mesh is None else plan.context(mesh)


def plan_context(solver, plan: Optional[ShardPlan], mesh: Optional[Mesh] = None):
    """(placed solver, active plan context) for serving under a plan.

    Places the coupling matrix for the plan's layout on :func:`plan_mesh` —
    row-sharded over the ``"model"`` axis when it model-parallelizes and N
    divides — and returns the context manager that activates the plan for
    every solve inside.  ``plan=None`` (or a trivial 1×1 plan) is a no-op.
    """
    mesh = plan_mesh(plan, mesh, solver.params.weights.device)
    if mesh is not None:
        params = shard_lib.shard_onn_params(solver.params, plan, mesh)
        solver = dataclasses.replace(solver, params=params)
    return solver, plan_scope(plan, mesh)


def resolve_plan_args(
    mesh_spec: Optional[str], shard_batch: bool, device=None
) -> Optional[ShardPlan]:
    """The ShardPlan implied by the ``--mesh`` / legacy ``--shard-batch``
    flags, over the real local devices of ``device``'s type (the CUDA cards
    unless ``"cpu"``)."""
    if mesh_spec is not None and shard_batch:
        raise SystemExit("--mesh and --shard-batch are mutually exclusive")
    if mesh_spec is not None:
        return mesh_lib.build_shard_plan(mesh_spec, device=device)
    if shard_batch:
        warnings.warn(
            "--shard-batch is deprecated; use --mesh Bx1 (or --mesh auto)",
            DeprecationWarning,
            stacklevel=2,
        )
        if local_device_count(device) < 2:
            return None
        return plan_of_legacy_shard_batch(device=device)
    return None


def _stacked_results(results) -> ONNResult:
    """The per-request results as one ``ONNResult`` of stacked CPU fields,
    read from the device in one copy."""
    fields = [torch.stack([getattr(r, f) for r in results]) for f in ONNResult._fields]
    flat = [f.to(torch.int32).reshape(f.shape[0], -1) for f in fields]
    host = torch.cat(flat, dim=1).cpu().split([f.shape[1] for f in flat], dim=1)
    return ONNResult(*(h.reshape(f.shape).to(f.dtype) for h, f in zip(host, fields)))


def serve_corrupted(
    solver: RetrievalSolver,
    targets: torch.Tensor,
    corrupted: torch.Tensor,
    generator: torch.Generator,
    *,
    corruption: float,
    batch_buckets: Tuple[int, ...] = DEFAULT_BATCH_BUCKETS,
    n_policy: Any = "pow2",
    coalesce: bool = True,
    plan: Optional[ShardPlan] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[Dict[str, Any], ONNResult]:
    """Serve each row of ``corrupted`` (R, N) as one request and score it
    against the same row of ``targets``; ``corruption`` is reported.

    The engine is rooted in ``generator`` (a CPU ``torch.Generator``), which
    seeds one generator per request.  ``plan`` / ``mesh``: serve under a
    ShardPlan (:func:`plan_context`).  Returns (report, the requests'
    results stacked on the CPU).
    """
    solver, plan_ctx = plan_context(solver, plan, mesh)
    dev = solver.params.weights.device
    n_requests, n = corrupted.shape
    batch = corrupted.to(device=dev, dtype=torch.int8)
    eng = Engine(generator, device=dev, batch_buckets=batch_buckets, n_policy=n_policy,
                 coalesce=coalesce)
    eng.install("retrieval", solver.as_engine_solver())

    t0 = time.perf_counter()
    with plan_ctx:
        futures = [eng.submit(Request("retrieval", batch[i])) for i in range(n_requests)]
        stats = eng.drain()
    res = _stacked_results([f.result() for f in futures])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    # Phase patterns are defined up to a global flip (spin symmetry).
    out = res.final_sigma.to(torch.int32)
    tgt = targets.cpu().to(torch.int32)
    match = torch.all(out == tgt, dim=1) | torch.all(out == -tgt, dim=1)
    max_cycles = solver.config.max_cycles
    cycles = torch.where(res.settled, res.settle_cycle, max_cycles)
    # Float32 means of exact integer sums, as the reference's jnp.mean.
    acc = float(np.float32(int(match.sum())) / np.float32(n_requests))
    settle = float(np.float32(int(cycles.to(torch.int64).sum())) / np.float32(n_requests))
    report = {
        "n_oscillators": n,
        "requests": n_requests,
        "corruption": corruption,
        "accuracy": acc,
        "mean_settle_cycles": round(settle, 2),
        "timeouts": int((~res.settled).sum()),
        "wall_s": round(dt, 3),
        "requests_per_s": round(n_requests / max(dt, 1e-9), 1),
        "engine": {
            "slabs": stats["slabs"],
            "pad_fraction": round(stats["pad_fraction"], 3),
            "slabs_per_bucket": stats["slabs_per_bucket"],
            # Measured settle-cycle cost model: quotes start at max_cycles
            # and tighten toward the early-exit EMA as slabs are served.
            "retrieval": stats["solvers"].get("retrieval", {}),
        },
        "device": str(dev),
        "mesh_devices": 1 if plan is None else plan.devices,
        "shard_plan": None if plan is None else dataclasses.asdict(plan),
    }
    return report, res


def serve_requests(
    solver: RetrievalSolver,
    xi: torch.Tensor,
    corruption: float,
    n_requests: int,
    seed: int = 0,
    *,
    batch_buckets: Tuple[int, ...] = DEFAULT_BATCH_BUCKETS,
    n_policy: Any = "pow2",
    coalesce: bool = True,
    plan: Optional[ShardPlan] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, Any]:
    """Draw ``n_requests`` corrupted patterns of ``xi`` from one CPU generator
    seeded with ``seed`` and serve them through one engine rooted in it,
    under ``plan`` on ``mesh`` when given (:func:`plan_context`)."""
    gen = torch.Generator().manual_seed(seed)
    which, corrupted = draw_requests(xi, corruption, n_requests, gen)
    report, _ = serve_corrupted(
        solver, xi.cpu()[which], corrupted, gen, corruption=corruption,
        batch_buckets=batch_buckets, n_policy=n_policy, coalesce=coalesce,
        plan=plan, mesh=mesh,
    )
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="10x10", choices=list(pat.DATASET_SHAPES))
    ap.add_argument("--architecture", default="hybrid", choices=["hybrid", "recurrent"])
    ap.add_argument("--mode", default="functional", choices=["functional", "rtl"])
    ap.add_argument("--corruption", type=float, default=0.25)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--backend", default="parallel",
                    choices=["parallel", "serial", "kernel", "hybrid"],
                    help="weighted-sum schedule for the coupling sum")
    ap.add_argument("--parallel-factor", type=int, default=0,
                    help="MAC width P of --backend hybrid: the coupling sum "
                         "serializes into ceil(N/P) passes (0 = auto)")
    ap.add_argument("--hybrid-impl", default="scan", choices=["scan", "kernel"],
                    help="execution route of --backend hybrid: pass by pass in "
                         "PyTorch, or the card's hybrid kernels")
    ap.add_argument("--settle-chunk", type=int, default=8,
                    help="cycles between early-exit checks (0 = fixed run)")
    ap.add_argument("--mesh", default=None, metavar="BxM",
                    help="ShardPlan mesh: B-way data-parallel lanes x M-way "
                         "row-sharded coupling matrix (e.g. 2x4), or 'auto' "
                         "(ft.propose_mesh over the local devices)")
    ap.add_argument("--shard-batch", action="store_true",
                    help="deprecated: use --mesh Bx1; splits request slabs "
                         "over all local devices (no-op on one device)")
    ap.add_argument("--n-policy", default="pow2",
                    help='engine N bucketing: "pow2", "exact", or comma sizes')
    ap.add_argument("--max-batch", type=int, default=max(DEFAULT_BATCH_BUCKETS),
                    help="largest engine batch bucket")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="serve each request in its own slab (latency-first)")
    ap.add_argument("--device", default=None,
                    help='where to train and serve: the GPU unless "cpu"')
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    plan = resolve_plan_args(args.mesh, args.shard_batch, args.device)
    solver, xi = build_solver(
        args.dataset, args.architecture, args.mode, backend=args.backend,
        settle_chunk=args.settle_chunk, parallel_factor=args.parallel_factor,
        hybrid_impl=args.hybrid_impl, device=args.device,
    )
    policy: Any = args.n_policy
    if policy not in ("pow2", "exact"):
        policy = tuple(int(s) for s in policy.split(","))
    buckets = tuple(b for b in DEFAULT_BATCH_BUCKETS if b <= args.max_batch) or (1,)
    print(json.dumps(serve_requests(
        solver, xi, args.corruption, args.requests, args.seed,
        batch_buckets=buckets, n_policy=policy, coalesce=not args.no_coalesce,
        plan=plan,
    ), indent=1))


if __name__ == "__main__":
    main()
