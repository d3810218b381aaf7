"""End-to-end LM training with checkpoint/restart on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_train_lm.py [--arch qwen2-1.5b] [--steps 40] [--device cpu]

Trains a reduced config of an assigned architecture on the deterministic
synthetic token stream (``repro_torch.launch.train``), demonstrating:

  * the loss decreasing (the stream has learnable n-gram structure),
  * async checkpointing and auto-resume: the run is interrupted at half its
    steps (a preemption notice, SIGTERM) and restarted from its checkpoint,
    and the resumed losses continue the curve,
  * the straggler monitor and heartbeat wired into the loop.

Runs on the card unless ``--device cpu``.
"""

import argparse
import os
import shutil
import signal
import tempfile

from repro_torch.distributed import ft
from repro_torch.launch import train as launch_train


def main(arch: str = "qwen2-1.5b", steps: int = 40, batch: int = 4, seq: int = 64,
         device=None) -> dict:
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    half = steps // 2
    stop = ft.StepMonitor.stop

    def preempt_at_half(self, step):  # the notice arrives during step `half`
        if step + 1 == half:
            os.kill(os.getpid(), signal.SIGTERM)
        return stop(self, step)

    kw = dict(reduced=True, steps=steps, batch=batch, seq_len=seq, ckpt_dir=ckpt_dir,
              ckpt_every=max(half // 2, 1), log_every=0, lr=1e-3, device=device)
    try:
        print(f"=== phase 1: train, preempted at step {half} ===")
        ft.StepMonitor.stop = preempt_at_half
        try:
            out1 = launch_train.train(arch, **kw)
        finally:
            ft.StepMonitor.stop = stop
        assert out1["status"] == "preempted" and out1["final_step"] == half, out1
        print(f"=== phase 2: resume from checkpoint → step {steps} ===")
        out2 = launch_train.train(arch, **kw)
        assert out2["status"] == "completed" and out2["final_step"] == steps, out2
        assert len(out2["losses"]) == steps - half, "the resumed run replayed steps"
        first, last = out1["first_loss"], out2["last_loss"]
        print(f"\nloss {first:.4f} → {last:.4f} over {steps} steps (resumed at {half})")
        assert last < first, "loss did not decrease"
        print("OK: loss decreased across a checkpoint/restart boundary")
        return {"first_loss": first, "last_loss": last, "resumed_at": half,
                "losses": out1["losses"] + out2["losses"]}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args()
    main(args.arch, args.steps, args.batch, args.seq, args.device)
