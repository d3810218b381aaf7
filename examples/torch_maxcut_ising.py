"""Oscillatory Ising machine on the PyTorch/CUDA port: solve max-cut with the
batched ONN (paper §2.2).

    PYTHONPATH=src python examples/torch_maxcut_ising.py [--n 64] [--replicas 8] \
        [--backend hybrid --parallel-factor 32] [--device cpu]

Embeds an Erdős–Rényi graph as antiferromagnetic couplings (J = −A,
quantized to 5 bits) and anneals with grouped-staggered ONN sweeps:
``--replicas`` independent anneals advance together through the configured
weighted-sum backend (``hybrid`` runs the paper's serialized-MAC datapath),
``--stagger-groups`` enable groups fire per sweep (N = fully asynchronous),
and ``--stagnation`` stops replicas that no longer improve.  The graph and
the solver's draws come from seeded CPU generators.  Reports the best cut
found vs the random-cut baseline |E|/2.  Runs on the card unless
``--device cpu``.
"""

import argparse

import torch

from repro_torch.api import MaxCutSolver
from repro_torch.core.ising import random_graph


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--p", type=float, default=0.5)
    ap.add_argument("--sweeps", type=int, default=64)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--stagger-groups", type=int, default=0,
                    help="enable groups per sweep (0 = auto, N = fully async)")
    ap.add_argument("--stagnation", type=int, default=12,
                    help="sweeps without improvement before a replica stops")
    ap.add_argument("--backend", default="parallel",
                    choices=["parallel", "serial", "kernel", "hybrid"])
    ap.add_argument("--parallel-factor", type=int, default=0)
    ap.add_argument("--device", default=None, help='the GPU unless "cpu"')
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    adj = random_graph(torch.Generator().manual_seed(args.seed), args.n, args.p)
    edges = float(torch.triu(adj, 1).sum())
    # MaxCutSolver implements the same Solver protocol as RetrievalSolver.
    solver = MaxCutSolver(
        sweeps=args.sweeps,
        replicas=args.replicas,
        stagger_groups=args.stagger_groups,
        stagnation=args.stagnation,
        backend=args.backend,
        parallel_factor=args.parallel_factor,
        device=args.device,
    )
    res = solver.solve(adj, key=torch.Generator().manual_seed(args.seed + 1))

    print(f"G({args.n}, {args.p}): |E| = {int(edges)}")
    print(f"cut found:       {int(res.cut_value)}")
    print(f"random baseline: {edges / 2:.0f}")
    print(f"ratio:           {float(res.cut_value) / (edges / 2):.3f}")
    print(f"replica cuts:    {[int(c) for c in res.replica_cuts.cpu()]}")
    print(f"sweeps run:      {int(res.sweeps_run)} / {args.sweeps}")
    part = int((res.sigma > 0).sum())
    print(f"partition sizes: {part} / {args.n - part}")
    trace = [int(v) for v in res.trace.cpu()[:: max(1, args.sweeps // 8)]]
    print(f"best-cut trace:  {trace}")


if __name__ == "__main__":
    main()
