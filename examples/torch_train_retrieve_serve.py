"""Train → hot-install → serve, on a live engine of the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_train_retrieve_serve.py [--dataset 10x10] \
        [--device cpu]

The ONN version of "train a model and roll it into a running server without
a restart", through the port's launcher (``repro_torch.launch.train_onn``).
The serving engine starts on plain Hebbian 5-bit weights and is already
streaming corrupted probes when quantization-aware DO-I training finishes;
the trained weights go through an ONN checkpoint round trip and are
hot-swapped in at a settle-chunk boundary — in-flight lanes finish on the
old weights, no kernel is built and no launch plan made anew, and the same
probe stream is then served again on the new ones.  The printed report
shows the retrieval accuracy before/after, the training telemetry, and the
serving counters (``hot_swaps`` and the zero post-swap build count).  Runs
on the card unless ``--device cpu``.
"""

import argparse
import json
import shutil
import tempfile

from repro_torch.launch.train_onn import run_train_serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default=None,
                    help="one dataset (e.g. 7x6); default sweeps 5x4/7x6/10x10")
    ap.add_argument("--corruption", type=float, default=0.15)
    ap.add_argument("--probes", type=int, default=24)
    ap.add_argument("--no-qat", action="store_true")
    ap.add_argument("--backend", default="parallel",
                    choices=("parallel", "serial", "kernel", "hybrid"))
    ap.add_argument("--device", default=None, help='the GPU unless "cpu"')
    args = ap.parse_args()

    datasets = [args.dataset] if args.dataset else ["5x4", "7x6", "10x10"]
    ckpt_dir = tempfile.mkdtemp(prefix="onn_ckpt_")
    try:
        print("dataset,n,acc_hebbian,acc_trained,sweeps,kappa_min,"
              "hot_swaps,retraces_after_swap")
        reports = []
        for dataset in datasets:
            r = run_train_serve(
                dataset=dataset,
                corruption=args.corruption,
                probes=args.probes,
                ckpt_dir=ckpt_dir,
                qat=not args.no_qat,
                backend=args.backend,
                device=args.device,
            )
            reports.append(r)
            print(
                f"{r['dataset']},{r['n']},{r['accuracy_hebbian']:.3f},"
                f"{r['accuracy_trained']:.3f},{r['train']['sweeps']},"
                f"{r['train']['kappa_min']:.3f},{r['hot_swaps']},"
                f"{r['serving_retraces_after_swap']}"
            )
        print("\nlast full report:")
        print(json.dumps(reports[-1], indent=1, default=str))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
