"""Continuous batching under live load on the PyTorch/CUDA port: the serving
daemon end to end.

    PYTHONPATH=src python examples/torch_serving_load.py [--device cpu]

Builds a :class:`repro_torch.serving.ContinuousEngine` with the standard
mixed workloads (two retrieval sizes + max-cut), then drives it with an
open-loop Poisson arrival stream through a
:class:`repro_torch.serving.ServeDaemon`: requests join in-flight slabs at
settle-chunk boundaries, early-exiting lanes free slots for queued work,
tenants share capacity by weight, and a heartbeat file tracks liveness.
Results equal solving each request alone — scheduling changes *when* a lane
runs, never what it computes.  Runs on the card unless ``--device cpu``.

Try ``kill -TERM <pid>`` while it runs: in-flight lanes complete, the
queue is shed with ``DrainRejectedError``, and the report says so.
"""

import argparse
import json
import os
import tempfile

import torch

from repro_torch import serving


def main(seed: int = 0, device=None):
    eng = serving.ContinuousEngine(
        torch.Generator().manual_seed(seed),
        device=device,
        slab_lanes=8,
        tenant_weights={"alpha": 2.0, "beta": 1.0},  # alpha gets 2x the lanes
        max_queue_lanes=256,  # admission control: beyond this, submit() rejects
    )
    serving.install_mixed_workloads(eng, sweeps=8)

    n_requests, rate_rps = 48, 30.0
    requests = serving.mixed_requests(n_requests, seed=0)
    offsets = serving.poisson_offsets(n_requests, rate_rps, seed=0)

    hb_path = os.path.join(tempfile.gettempdir(), "onn_serving_heartbeat")
    daemon = serving.ServeDaemon(
        eng,
        heartbeat_path=hb_path,
        straggler_z=4.0,
        idle_sleep_s=0.0005,
    )
    print(f"serving {n_requests} mixed requests at ~{rate_rps:.0f} req/s "
          f"(pid {os.getpid()}, heartbeat {hb_path})")
    report = daemon.run(serving.timed_source(requests, offsets))

    serving_stats = report["stats"]["serving"]
    print(json.dumps({
        "completed": report["completed"],
        "rejected": report["rejected"],
        "preempted": report["preempted"],
        "ticks": report["ticks"],
        "mid_flight_joins": serving_stats["mid_flight_joins"],
        "slabs_opened": serving_stats["slabs_opened"],
        "latency_p50_ms": round(report["latency"]["p50_s"] * 1e3, 2),
        "latency_p99_ms": round(report["latency"]["p99_s"] * 1e3, 2),
        "per_tenant": report["stats"]["tenants"],
    }, indent=1))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help='the GPU unless "cpu"')
    args = ap.parse_args()
    main(args.seed, args.device)
