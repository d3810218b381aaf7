"""One engine, mixed workloads, on the PyTorch/CUDA port: retrieval + max-cut
through one surface.

    PYTHONPATH=src python examples/torch_engine_mixed_workloads.py [--device cpu]

Installs the paper's two ONN workloads — associative-memory retrieval
(Fig. 7) and max-cut annealing (§2.2) — on one ``repro_torch.engine.Engine``,
submits an interleaved request stream, and drains it.  The engine pads
every request to a (batch, N) bucket so mixed sizes share launch plans,
seeds one generator per request from its CPU root generator, and quotes
each request's latency next to the paper-hardware time-to-solution it
models.  Runs on the card unless ``--device cpu``.
"""

import argparse
import json

import torch

from repro_torch import engine
from repro_torch.core.ising import random_graph
from repro_torch.data import patterns as pat


def main(seed: int = 0, device=None):
    eng = engine.Engine(torch.Generator().manual_seed(seed), device=device,
                        batch_buckets=(1, 2, 4, 8))

    # Workload 1: pattern retrieval on the 10×10 letter set (N=100 → bucket 128).
    xi = pat.load_dataset("10x10", device="cpu")
    eng.install("letters", "retrieval", xi=xi, architecture="hybrid", device=eng.device)

    # Workload 2: max-cut on random graphs (N∈{20..40} → bucket 64).
    eng.install("cuts", "maxcut", sweeps=32, device=eng.device)

    # Quote before running: model-based cold start + FPGA context.
    est = eng.estimate("letters", xi[0])
    print(f"retrieval quote: {est.seconds:.4f}s software "
          f"({est.source}); paper hybrid FPGA ≈ {est.fpga_seconds:.4f}s")

    gen = torch.Generator().manual_seed(seed + 1)
    futures = {}
    for i in range(6):  # interleave the two workloads
        if i % 2 == 0:
            corrupted = pat.corrupt(xi[i % xi.shape[0]], 0.25, generator=gen)
            futures[f"retrieve#{i}"] = eng.submit(engine.Request("letters", corrupted))
        else:
            adj = random_graph(gen, 20 + 4 * i, 0.5)
            futures[f"maxcut#{i}"] = eng.submit(engine.Request("cuts", adj))

    stats = eng.drain()

    for name, fut in futures.items():
        res = fut.result()
        if name.startswith("retrieve"):
            i = int(name.split("#")[1])
            ok = bool(torch.all(res.final_sigma.cpu() == xi[i % xi.shape[0]]))
            print(f"{name}: retrieved={ok} settle_cycle={int(res.settle_cycle)}")
        else:
            print(f"{name}: cut_value={float(res.cut_value):.0f} n={res.sigma.shape[0]}")

    print(json.dumps({k: stats[k] for k in
                      ("submitted", "completed", "slabs", "pad_fraction")}, indent=1))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help='the GPU unless "cpu"')
    args = ap.parse_args()
    main(args.seed, args.device)
