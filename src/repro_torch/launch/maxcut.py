"""Max-cut serving CLI: the oscillatory Ising machine behind
``repro_torch.engine`` (the port of ``repro.launch.maxcut``).

Generates a stream of Erdős–Rényi instances with the port's
``random_graph`` from a ``torch.Generator`` seeded by ``--seed``, installs a
batched ``MaxCutSolver`` on a serving engine, and submits each instance as
one request.  The engine coalesces instances into shape-bucketed slabs; the
batched annealer (``repro_torch.core.ising.solve_maxcut_batch``) runs every
slab through the configured weighted-sum backend — ``--backend hybrid
--parallel-factor P`` computes with the paper's serialized-MAC datapath,
``--hybrid-impl kernel`` with the card's kernels — with ``--replicas``
independent anneals per instance and ``--stagger-groups`` update groups per
sweep.  Each request equals its isolated solve: the same (instance, seed)
returns the same cut under every ``--n-policy``.  It runs on the card unless
``--device cpu``.

``--mesh BxM`` activates a :class:`repro_torch.distributed.ShardPlan`: the
instances of a slab split B ways over the data axis while the coupling
field of every instance is computed through the M-way row-sharded
``weighted_sum`` collective (``auto`` asks ``ft.propose_mesh``), over the
real local devices.  The legacy ``--shard-batch`` flag still works as a
deprecated alias for an all-data mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.maxcut --n 506 --requests 16 \\
      --backend kernel --replicas 64 --stagnation 16
  PYTHONPATH=src python -m repro_torch.launch.maxcut --device cpu --n 24 --requests 4
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.api import MaxCutSolver
from repro_torch.core.checks import resolve_device
from repro_torch.core.ising import random_graph
from repro_torch.distributed import Mesh, ShardPlan
from repro_torch.engine import DEFAULT_BATCH_BUCKETS, Engine, Request
from repro_torch.launch.retrieve import plan_mesh, plan_scope, resolve_plan_args


def serve_cuts(
    solver: MaxCutSolver,
    n: int,
    n_requests: int,
    edge_prob: float = 0.5,
    seed: int = 0,
    *,
    batch_buckets: Tuple[int, ...] = DEFAULT_BATCH_BUCKETS,
    n_policy: Any = "pow2",
    coalesce: bool = True,
    plan: Optional[ShardPlan] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, Any]:
    """Solve ``n_requests`` random G(n, edge_prob) instances through one engine.

    One CPU generator seeded with ``seed`` draws the graphs, then roots the
    engine, which seeds one generator per request on the solver's device.
    ``plan``: serve under a ShardPlan, on ``mesh`` (default: the plan's mesh
    over the local devices of the solver's device type).
    """
    dev = resolve_device(solver.device)
    plan_ctx = plan_scope(plan, plan_mesh(plan, mesh, dev))
    gen = torch.Generator().manual_seed(seed)
    adjs = [random_graph(gen, n, edge_prob) for _ in range(n_requests)]

    eng = Engine(gen, device=solver.device, batch_buckets=batch_buckets,
                 n_policy=n_policy, coalesce=coalesce)
    eng.install("maxcut", solver.as_engine_solver())
    quote = eng.estimate("maxcut", adjs[0])

    t0 = time.perf_counter()
    with plan_ctx:
        futures = [eng.submit(Request("maxcut", a)) for a in adjs]
        stats = eng.drain()
    results = [f.result() for f in futures]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    edges = torch.stack([torch.triu(a, 1).sum() for a in adjs]).to(torch.float32)
    cuts = torch.stack([r.cut_value for r in results]).cpu()
    ratios = cuts / torch.clamp(edges / 2.0, min=1.0)  # vs the |E|/2 random baseline
    sweeps_run = torch.stack([r.sweeps_run for r in results]).cpu().to(torch.float32)
    return {
        "n": n,
        "edge_prob": edge_prob,
        "requests": n_requests,
        "replicas": solver.replicas,
        "stagger_groups": solver.stagger_groups,
        "backend": solver.backend,
        "device": str(dev),
        "mean_cut": round(float(cuts.mean()), 2),
        "mean_ratio_vs_half_edges": round(float(ratios.mean()), 4),
        "min_ratio_vs_half_edges": round(float(ratios.min()), 4),
        "mean_sweeps_run": round(float(sweeps_run.mean()), 2),
        "wall_s": round(dt, 3),
        "requests_per_s": round(n_requests / max(dt, 1e-9), 1),
        "estimate": {
            "seconds": round(quote.seconds, 6),
            "source": quote.source,
            "fpga_seconds": quote.fpga_seconds,
            # The paper's architecture trade, quoted per Ising request.
            "fpga_tradeoff": quote.fpga_tradeoff,
        },
        "engine": {
            "slabs": stats["slabs"],
            "pad_fraction": round(stats["pad_fraction"], 3),
            "slabs_per_bucket": stats["slabs_per_bucket"],
            "maxcut": stats["solvers"].get("maxcut", {}),
        },
        "mesh_devices": 1 if plan is None else plan.devices,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64, help="vertices per instance")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--edge-prob", type=float, default=0.5)
    ap.add_argument("--sweeps", type=int, default=64)
    ap.add_argument("--replicas", type=int, default=4, help="independent anneals per instance")
    ap.add_argument("--stagger-groups", type=int, default=0,
                    help="update groups K per sweep (0 = auto, N = fully async)")
    ap.add_argument("--stagnation", type=int, default=0,
                    help="sweeps without improvement before a replica stops "
                         "(0 = run all sweeps)")
    ap.add_argument("--weight-bits", type=int, default=5)
    ap.add_argument("--backend", default="parallel",
                    choices=["parallel", "serial", "kernel", "hybrid"],
                    help="weighted-sum schedule for the coupling field")
    ap.add_argument("--parallel-factor", type=int, default=0,
                    help="MAC width P of --backend hybrid (0 = auto)")
    ap.add_argument("--hybrid-impl", default="scan", choices=["scan", "kernel"])
    ap.add_argument("--settle-chunk", type=int, default=8, help="sweeps between early-exit checks")
    ap.add_argument("--n-policy", default="pow2",
                    help='engine N bucketing: "pow2", "exact", or comma sizes')
    ap.add_argument("--max-batch", type=int, default=max(DEFAULT_BATCH_BUCKETS),
                    help="largest engine batch bucket")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="serve each request in its own slab (latency-first)")
    ap.add_argument("--mesh", default=None, metavar="BxM",
                    help="ShardPlan mesh: B-way data-parallel instances x "
                         "M-way row-sharded coupling sum (e.g. 2x4), or "
                         "'auto' (ft.propose_mesh over the local devices)")
    ap.add_argument("--shard-batch", action="store_true",
                    help="deprecated: use --mesh Bx1; splits request slabs "
                         "over all local devices (no-op on one device)")
    ap.add_argument("--device", default=None,
                    help='where to solve: the GPU unless "cpu"')
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    plan = resolve_plan_args(args.mesh, args.shard_batch, args.device)

    solver = MaxCutSolver(
        sweeps=args.sweeps,
        weight_bits=args.weight_bits,
        replicas=args.replicas,
        stagger_groups=args.stagger_groups,
        stagnation=args.stagnation,
        backend=args.backend,
        parallel_factor=args.parallel_factor,
        hybrid_impl=args.hybrid_impl,
        settle_chunk=args.settle_chunk,
        device=args.device,
    )
    policy: Any = args.n_policy
    if policy not in ("pow2", "exact"):
        policy = tuple(int(s) for s in policy.split(","))
    buckets = tuple(b for b in DEFAULT_BATCH_BUCKETS if b <= args.max_batch) or (1,)
    print(json.dumps(serve_cuts(
        solver, args.n, args.requests, args.edge_prob, args.seed,
        batch_buckets=buckets, n_policy=policy, coalesce=not args.no_coalesce,
        plan=plan,
    ), indent=1))


if __name__ == "__main__":
    main()
