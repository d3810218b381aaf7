"""The long-lived ONN serve daemon: continuous batching under live load (the
port of ``repro.launch.serve_daemon``).

Builds a :class:`repro_torch.serving.ContinuousEngine` with the standard
mixed workloads (two retrieval sizes trained with DO-I, and max-cut), wraps
it in a :class:`repro_torch.serving.ServeDaemon` (SIGTERM drain, heartbeat
liveness, per-slab latency anomaly detection) and drives it with an
open-loop Poisson arrival stream.  Prints the run report as JSON.  It serves
on the card unless ``--device cpu``.

Send SIGTERM to observe the graceful drain: in-flight slabs complete,
queued requests are rejected (or served with ``--drain-queue``), the
heartbeat file goes stale after exit.

``--mesh BxM`` runs the whole daemon under a
:class:`repro_torch.distributed.ShardPlan`: streaming slabs split B ways
over the data axis and every coupling sum runs the M-way row-sharded
collective, over the real local devices.  ``--mesh auto`` sizes the plan
with ``repro_torch.distributed.ft.propose_mesh`` — the same elastic re-mesh
policy the daemon's fault-tolerance hooks assume after a device loss.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_daemon --rate 20 --requests 200
  PYTHONPATH=src python -m repro_torch.launch.serve_daemon --device cpu --ticked 4 \\
      --requests 16   # no wall clock
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Optional, Tuple

import torch

from repro_torch import serving
from repro_torch.core.checks import resolve_device
from repro_torch.distributed import Mesh, ShardPlan
from repro_torch.launch.retrieve import plan_mesh, plan_scope, resolve_plan_args


def parse_weights(spec: str) -> Tuple[Tuple[str, float], ...]:
    """``"alpha=2,beta=1"`` → (("alpha", 2.0), ("beta", 1.0))."""
    out = []
    for part in spec.split(","):
        name, _, w = part.partition("=")
        if not name:
            raise ValueError(f"bad tenant spec {spec!r}")
        out.append((name.strip(), float(w) if w else 1.0))
    return tuple(out)


def run_daemon(
    *,
    rate_rps: float = 20.0,
    n_requests: int = 100,
    seed: int = 0,
    slab_lanes: Optional[int] = None,
    max_queue_lanes: Optional[int] = None,
    tenants: Tuple[Tuple[str, float], ...] = serving.load.DEFAULT_TENANTS,
    heartbeat_path: Optional[str] = None,
    sweeps: int = 8,
    drain_queue_on_term: bool = False,
    ticked: int = 0,
    max_ticks: Optional[int] = None,
    onn_ckpt: Optional[str] = None,
    device=None,
    plan: Optional[ShardPlan] = None,
    mesh: Optional[Mesh] = None,
) -> Dict:
    """Serve ``n_requests`` of the mixed stream on ``device`` (the GPU
    unless ``"cpu"``); returns the daemon's report.  ``plan``: run the whole
    daemon under a ShardPlan, on ``mesh`` (default: the plan's mesh over the
    local devices of ``device``'s type)."""
    dev = resolve_device(device)
    eng = serving.ContinuousEngine(
        torch.Generator().manual_seed(seed),
        device=dev,
        slab_lanes=slab_lanes,
        tenant_weights=dict(tenants),
        max_queue_lanes=max_queue_lanes,
    )
    serving.install_mixed_workloads(eng, sweeps=sweeps, small_ckpt=onn_ckpt)
    requests = serving.mixed_requests(n_requests, seed=seed, tenants=tenants)
    if ticked > 0:  # deterministic per-tick arrivals (no wall clock)
        source = serving.ticked_source(requests, per_tick=ticked)
    else:
        source = serving.timed_source(
            requests, serving.poisson_offsets(n_requests, rate_rps, seed=seed)
        )
    daemon = serving.ServeDaemon(
        eng,
        heartbeat_path=heartbeat_path,
        drain_queue_on_term=drain_queue_on_term,
        max_ticks=max_ticks,
    )
    with plan_scope(plan, plan_mesh(plan, mesh, dev)):
        report = daemon.run(source)
    if plan is not None:
        report["shard_plan"] = dataclasses.asdict(plan)
    report["device"] = str(dev)
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rate", type=float, default=20.0, help="arrival rate (req/s)")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slab-lanes", type=int, default=None,
                    help="streaming slab lane capacity (default: largest batch bucket)")
    ap.add_argument("--max-queue-lanes", type=int, default=None,
                    help="admission bound: reject when queue exceeds this many lanes")
    ap.add_argument("--tenants", type=parse_weights,
                    default=serving.load.DEFAULT_TENANTS,
                    help='tenant weights, e.g. "alpha=2,beta=1"')
    ap.add_argument("--heartbeat", default=None, help="liveness file path")
    ap.add_argument("--sweeps", type=int, default=8, help="max-cut anneal sweeps")
    ap.add_argument("--drain-queue", action="store_true",
                    help="serve (not reject) the queue on SIGTERM")
    ap.add_argument("--ticked", type=int, default=0,
                    help="deterministic source: N requests per tick (0 = Poisson)")
    ap.add_argument("--max-ticks", type=int, default=None)
    ap.add_argument("--onn-ckpt", default=None,
                    help="restore the small retrieval workload from this ONN checkpoint")
    ap.add_argument("--mesh", default=None, metavar="BxM",
                    help="ShardPlan mesh for the daemon: B-way data-parallel "
                         "slabs x M-way row-sharded coupling sums, or 'auto' "
                         "(ft.propose_mesh over the local devices)")
    ap.add_argument("--shard-batch", action="store_true",
                    help="deprecated: use --mesh Bx1; splits streaming slabs "
                         "over all local devices")
    ap.add_argument("--device", default=None,
                    help='where to serve: the GPU unless "cpu"')
    args = ap.parse_args()
    plan = resolve_plan_args(args.mesh, args.shard_batch, args.device)
    report = run_daemon(
        rate_rps=args.rate,
        n_requests=args.requests,
        seed=args.seed,
        slab_lanes=args.slab_lanes,
        max_queue_lanes=args.max_queue_lanes,
        tenants=args.tenants,
        heartbeat_path=args.heartbeat,
        sweeps=args.sweeps,
        drain_queue_on_term=args.drain_queue,
        ticked=args.ticked,
        max_ticks=args.max_ticks,
        onn_ckpt=args.onn_ckpt,
        device=args.device,
        plan=plan,
    )
    print(json.dumps(report, indent=1, default=str))


if __name__ == "__main__":
    main()
