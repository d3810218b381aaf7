"""Quickstart of the PyTorch/CUDA port: train an ONN on letter patterns and
retrieve a corrupted one.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Walks the paper's Figure-1 loop end to end with the port's functional API
(``repro_torch.api``), on the card unless ``--device cpu``:
  1. load the 10×10 letter dataset (five patterns),
  2. train coupling weights with the Diederich–Opper I rule,
  3. quantize to the paper's 5-bit signed format and build ``OnnParams``,
  4. corrupt a pattern by 25 % (pixels drawn from a seeded CPU
     ``torch.Generator``) and let the hybrid-architecture ONN settle,
  5. print the retrieved pattern next to the target.

Only the config fixes the launch plans: rebuilding params with other
same-N weights (here plain Hebbian instead of DO-I) reuses them.
"""

import argparse

import torch

from repro_torch import api
from repro_torch.core.learning import diederich_opper_i, hebbian
from repro_torch.core.quantization import quantize_weights
from repro_torch.data import patterns as pat


def show(sigma, rows, cols, title):
    print(title)
    grid = sigma.cpu().reshape(rows, cols)
    for r in range(rows):
        print("  " + "".join("█" if v > 0 else "·" for v in grid[r]))


def retrieved(result, target) -> bool:
    sigma = result.final_sigma
    return bool(torch.all(sigma == target) | torch.all(sigma == -target))


def main(seed: int = 42, device=None):
    dataset = "10x10"
    rows, cols = pat.DATASET_SHAPES[dataset]
    xi = pat.load_dataset(dataset, device=device)
    print(f"dataset {dataset}: {xi.shape[0]} patterns, N={xi.shape[1]} oscillators "
          f"on {xi.device}")

    do = diederich_opper_i(xi, device=device)
    print(f"DO-I converged={bool(do.converged)} in {int(do.sweeps)} sweeps")
    qw = quantize_weights(do.weights)  # 5-bit signed, the paper's precision

    cfg = api.ONNConfig(n=xi.shape[1], architecture="hybrid", mode="functional")
    params = api.make_params(cfg, qw.values, device=device)

    target = xi[0]
    corrupted = pat.corrupt(target.cpu(), 0.25, generator=torch.Generator().manual_seed(seed))
    corrupted = corrupted.to(xi.device)
    result = api.run(cfg, params, api.initial_phase(cfg, corrupted))

    show(target, rows, cols, "\ntarget:")
    show(corrupted, rows, cols, "\ncorrupted (25%):")
    show(result.final_sigma, rows, cols, "\nretrieved:")
    print(f"\nretrieved correctly: {retrieved(result, target)}, "
          f"settled at cycle {int(result.settle_cycle)}")

    # A different same-N coupling matrix (plain Hebbian instead of DO-I)
    # runs under the same config and launch plans.
    params2 = api.make_params(cfg, quantize_weights(hebbian(xi)).values, device=device)
    result2 = api.run(cfg, params2, api.initial_phase(cfg, corrupted))
    print(f"hebbian weights, same config: retrieved={retrieved(result2, target)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None, help='the GPU unless "cpu"')
    args = ap.parse_args()
    main(args.seed, args.device)
