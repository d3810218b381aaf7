"""The paper's pattern-retrieval benchmark as a batched serving workload, on
the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_pattern_retrieval.py [--requests 512] \
        [--backend kernel] [--device cpu]

Serves ``--requests`` corrupted-pattern requests through both FPGA
architectures (recurrent where it fits, hybrid everywhere) across all five
paper datasets with the port's launcher (``repro_torch.launch.retrieve``),
reporting accuracy / settle cycles / throughput.  Runs on the card unless
``--device cpu``.
"""

import argparse

from repro_torch.data import patterns as pat
from repro_torch.launch.retrieve import build_solver, serve_requests


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--corruption", type=float, default=0.25)
    ap.add_argument("--backend", default="parallel",
                    choices=["parallel", "serial", "kernel"])
    ap.add_argument("--device", default=None, help='the GPU unless "cpu"')
    args = ap.parse_args()

    print("dataset,arch,requests,accuracy,settle_cycles,req_per_s")
    for dataset, (rows, cols) in pat.DATASET_SHAPES.items():
        archs = ["recurrent", "hybrid"] if rows * cols <= 48 else ["hybrid"]
        for arch in archs:
            solver, xi = build_solver(dataset, arch, backend=args.backend, device=args.device)
            out = serve_requests(solver, xi, args.corruption, args.requests)
            print(
                f"{dataset},{arch},{out['requests']},{out['accuracy']:.3f},"
                f"{out['mean_settle_cycles']},{out['requests_per_s']}"
            )


if __name__ == "__main__":
    main()
