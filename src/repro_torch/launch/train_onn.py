"""Train → install → serve → measure, in one process (the port of
``repro.launch.train_onn``).

Trains the paper's associative memory with quantization-aware DO-I
(:mod:`repro_torch.train`) and installs the result into a **live** serving
engine mid-stream: the daemon starts on plain Hebbian 5-bit weights, serves a
corrupted-probe stream, hot-swaps the trained weights at a settle-chunk
boundary (in-flight lanes finish on the Hebbian weights; no kernel is built
and no launch plan is made anew), then serves the same probe stream again.
The report shows the retrieval-accuracy jump the swap bought, the training
telemetry (sweeps, min κ margin on the quantized weights) and the serving
counters.  It runs on the card unless ``--device cpu``.

Optionally checkpoints the trained ONN (``--ckpt-dir``); the install then
goes through a save → load round trip, proving the restore path the serve
daemon uses.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train_onn --dataset 22x22 --probes 128 \\
      --backend kernel
  PYTHONPATH=src python -m repro_torch.launch.train_onn --device cpu --dataset 7x6
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import torch

from repro_torch import api, serving, train
from repro_torch.checkpoint import load_onn, save_onn
from repro_torch.core import dynamics
from repro_torch.core.checks import resolve_device
from repro_torch.core.learning import hebbian
from repro_torch.core.quantization import quantize_weights
from repro_torch.data import patterns as data
from repro_torch.engine import Request, adapters
from repro_torch.kernels import autotune, build


def _hebbian_solver(xi: torch.Tensor, device, **cfg_kwargs: Any) -> api.RetrievalSolver:
    """The baseline the swap replaces: one-shot Hebbian at 5-bit weights."""
    cfg = dynamics.ONNConfig(n=xi.shape[1], **cfg_kwargs)
    qw = quantize_weights(hebbian(xi, self_coupling=False), cfg.weight_bits)
    return api.RetrievalSolver(
        config=cfg, params=dynamics.make_params(cfg, qw.values, device=device)
    )


def _probe_batch(xi: torch.Tensor, probes: int, corruption: float, seed: int) -> torch.Tensor:
    """(probes, N) on the CPU: probe i is pattern i % P with an exact-count
    random corruption, drawn from one CPU generator seeded with ``seed``."""
    patterns = xi.cpu()
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([
        data.corrupt(patterns[i % patterns.shape[0]], corruption, generator=gen)
        for i in range(probes)
    ])


def _accuracy(results: List[Any], targets: torch.Tensor) -> float:
    """Fraction of probes retrieved exactly (up to a global spin flip); the
    spins are read from the device in one copy."""
    sigma = torch.stack([r.final_sigma for r in results]).cpu()
    hits = torch.all(sigma == targets, dim=1) | torch.all(sigma == -targets, dim=1)
    return int(hits.sum()) / max(1, len(results))


def _serve_probes(eng: serving.ContinuousEngine, probes: torch.Tensor) -> List[Any]:
    futs = [eng.submit(Request("retrieval", p)) for p in probes]
    eng.flush()
    return [f.result() for f in futs]


def _builds_and_plans() -> int:
    """Kernel libraries built or loaded so far plus launch plans made so far
    (``autotune.cache_info()`` misses)."""
    return len(build.loaded()) + autotune.cache_info()["misses"]


def run_train_serve(
    *,
    dataset: str = "10x10",
    corruption: float = 0.15,
    probes: int = 24,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    max_sweeps: int = 500,
    qat: bool = True,
    backend: str = "parallel",
    settle_chunk: int = 4,
    device=None,
) -> Dict[str, Any]:
    """Serve Hebbian weights, train QAT DO-I, hot-swap, serve again, all on
    ``device`` (the GPU unless ``"cpu"``).

    ``serving_retraces_after_swap`` stands where the reference counts jit
    traces, which the port does not have: it is the kernel libraries built
    or loaded plus the new launch plans (misses of
    ``autotune.cache_info()``) from the tick before the swap to the end of
    the second serve.  A same-N swap makes none.
    """
    dev = resolve_device(device)
    xi = data.load_dataset(dataset, device=dev)
    xi_cpu = xi.cpu()
    eng = serving.ContinuousEngine(torch.Generator().manual_seed(seed), device=dev,
                                   slab_lanes=probes)
    solver = adapters.RetrievalEngineSolver(
        solver=_hebbian_solver(xi, dev, backend=backend, settle_chunk=settle_chunk)
    )
    eng.install("retrieval", solver)
    probe_set = _probe_batch(xi_cpu, probes, corruption, seed).to(dev)
    targets = xi_cpu[torch.arange(probes) % xi_cpu.shape[0]]

    # Warm the serving path (kernel builds, launch plans) so the count
    # below isolates the swap, then run phase 1 for real.
    _serve_probes(eng, probe_set)

    # Phase 1: submit every probe and take one tick — slab_lanes == probes,
    # so this admits the whole stream into one live slab on Hebbian weights.
    futs = [eng.submit(Request("retrieval", p)) for p in probe_set]
    eng.step()

    # Train while the slab is in flight; install at the settle-chunk
    # boundary.  In-flight lanes finish on the Hebbian weights they started
    # with, so the phase-1 accuracy below is purely pre-swap.
    compiled = _builds_and_plans()
    swap = train.HotSwap(eng, "retrieval")
    cfg_train = train.TrainConfig(
        qat_bits=solver.config.weight_bits if qat else 0, max_sweeps=max_sweeps
    )
    result = train.train_doi(xi, cfg_train, device=dev)
    params, qw = train.trained_params(solver.config, result.weights)
    checkpoint_path = None
    if ckpt_dir is not None:
        # Install through the save → load round trip (the daemon restore path).
        checkpoint_path = save_onn(
            os.path.join(ckpt_dir, "onn"),
            solver.config,
            qw,
            extra_meta={"dataset": dataset, "rule": "qat_doi" if qat else "doi"},
        )
        params = load_onn(checkpoint_path, device=dev).params
    swap.install(params)
    eng.flush()
    acc_hebbian = _accuracy([f.result() for f in futs], targets)

    # Phase 2: the same probes on the trained weights — nothing new built.
    after = _serve_probes(eng, probe_set)
    acc_trained = _accuracy(after, targets)
    serving_retraces = _builds_and_plans() - compiled

    stats = eng.stats()
    return {
        "dataset": dataset,
        "patterns": int(xi_cpu.shape[0]),
        "n": int(xi_cpu.shape[1]),
        "probes": probes,
        "corruption": corruption,
        "rule": "qat_doi" if qat else "doi",
        "train": {
            "sweeps": int(result.sweeps),
            "converged": bool(result.converged),
            "kappa_min": float(result.kappa_min),
        },
        "accuracy_hebbian": acc_hebbian,
        "accuracy_trained": acc_trained,
        "hot_swaps": stats["serving"]["hot_swaps"],
        "serving_retraces_after_swap": serving_retraces,
        "checkpoint": checkpoint_path,
        "ticks": stats["serving"]["ticks"],
        "completed": stats["completed"],
        "device": str(dev),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="10x10", choices=list(data.DATASET_SHAPES))
    ap.add_argument("--corruption", type=float, default=0.15)
    ap.add_argument("--probes", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint the trained ONN here (default: temp dir)")
    ap.add_argument("--max-sweeps", type=int, default=500)
    ap.add_argument("--no-qat", action="store_true",
                    help="train float DO-I instead of quantization-aware DO-I")
    ap.add_argument("--backend", default="parallel",
                    choices=("parallel", "serial", "kernel", "hybrid"))
    ap.add_argument("--settle-chunk", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help='where to train and serve: the GPU unless "cpu"')
    args = ap.parse_args()
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="onn_ckpt_")
    report = run_train_serve(
        dataset=args.dataset,
        corruption=args.corruption,
        probes=args.probes,
        seed=args.seed,
        ckpt_dir=ckpt_dir,
        max_sweeps=args.max_sweeps,
        qat=not args.no_qat,
        backend=args.backend,
        settle_chunk=args.settle_chunk,
        device=args.device,
    )
    print(json.dumps(report, indent=1, default=str))


if __name__ == "__main__":
    main()
