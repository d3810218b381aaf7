"""LM training loop: data pipeline, checkpoint/restart and the fault-tolerance
hooks (the port of ``repro.launch.train``).

Runs real steps on one device: the card unless ``--device cpu``.  The
weights come from ``params.materialize`` under one CPU
``torch.Generator().manual_seed(seed)``; the batches from
:class:`repro_torch.data.tokens.TokenStream` (the reference's stream,
batch for batch).  Demonstrated end to end by ``examples/torch_train_lm.py``
on a reduced config.

Fault-tolerance wiring:

* auto-resume from the latest complete checkpoint (params, optimizer state,
  step, and the data cursor in ``meta["data_state"]``), in the reference's
  checkpoint format: a directory either side wrote, the other resumes;
* async checkpointing every ``--ckpt-every`` steps (and at the end);
* SIGTERM-triggered immediate checkpoint (preemption notice);
* per-step straggler monitor (z-score wall-time outliers);
* heartbeat file for an external watchdog.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch qwen2-1.5b --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch import configs
from repro_torch import optim as optim_lib
from repro_torch.core.checks import resolve_device
from repro_torch.data.tokens import TokenStream
from repro_torch.distributed import ft
from repro_torch.models import params as PM
from repro_torch.models import steps as steps_lib
from repro_torch.models.model import get_model
from repro_torch.models.steps import TrainState


def build_state(model, optimizer, generator: torch.Generator, device=None) -> TrainState:
    """Step 0: the model's weights drawn from the CPU ``generator`` onto
    ``device`` (the GPU unless ``"cpu"``) and the optimizer's zero state."""
    dev = resolve_device(device)
    params = PM.materialize(model.param_specs, generator, dev)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev), params=params,
                      opt=optimizer.init(params))


def train(
    arch: str,
    *,
    reduced: bool = True,
    steps: int = 100,
    batch: int = 8,
    seq_len: int = 128,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    optimizer_name: str = "adamw",
    lr: float = 3e-4,
    microbatches: int = 1,
    seed: int = 0,
    data_mesh: int = 1,
    model_mesh: int = 1,
    log_every: int = 10,
    straggler_log: Optional[list] = None,
    device=None,
) -> Dict[str, Any]:
    """Train ``arch`` (its reduced config unless ``reduced=False``) for
    ``steps`` steps on ``device`` (the GPU unless ``"cpu"``).  Returns the
    reference's report (``final_step``, ``losses``, ``first_loss``,
    ``last_loss``, ``stragglers``, ``status``) and ``step_s``: each step's
    wall seconds on the host clock, ending in the read of its loss.
    ``data_mesh`` and ``model_mesh`` are accepted as the reference takes
    them; one device runs every step."""
    del data_mesh, model_mesh
    dev = resolve_device(device)
    cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
    model = get_model(cfg)
    optimizer = optim_lib.get_optimizer(
        optimizer_name, optim_lib.cosine_warmup(lr, max(steps // 10, 1), steps)
    )
    train_step = steps_lib.make_train_step(model, optimizer, microbatches=microbatches)

    stream = TokenStream(cfg.vocab, batch, seq_len, seed=seed)
    state = build_state(model, optimizer, torch.Generator().manual_seed(seed), dev)

    start_step = 0
    if ckpt_dir:
        latest = ckpt_lib.latest_step(ckpt_dir)
        if latest is not None:
            meta = ckpt_lib.load_meta(ckpt_dir, latest)
            state = ckpt_lib.restore(ckpt_dir, latest, state)
            stream.restore(meta["data_state"])
            start_step = latest
            print(f"[train] resumed from step {latest}", flush=True)

    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    monitor = ft.StepMonitor(
        on_straggler=(straggler_log.append if straggler_log is not None else None)
    )
    heartbeat = ft.Heartbeat(os.path.join(ckpt_dir, "heartbeat"), 5.0) if ckpt_dir else None

    losses, step_s = [], []
    extra = None

    def save_now(step_idx: int):
        if saver:
            saver.save(step_idx, state, extra_meta={"data_state": stream.state()})

    with ft.PreemptionGuard() as guard:
        for i in range(start_step, steps):
            t0 = time.perf_counter()
            monitor.start()
            state, metrics = train_step(state, stream.next())
            loss = float(metrics["loss"])
            losses.append(loss)
            monitor.stop(i)
            step_s.append(time.perf_counter() - t0)
            if heartbeat:
                heartbeat.beat(i)
            if log_every and (i + 1) % log_every == 0:
                print(
                    f"[train] step {i+1}/{steps} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.3f}",
                    flush=True,
                )
            if guard.preempted:
                print("[train] preemption notice — checkpointing and exiting", flush=True)
                save_now(i + 1)
                extra = "preempted"
                break
            if ckpt_dir and (i + 1) % ckpt_every == 0:
                save_now(i + 1)

    if saver:
        save_now(int(state.step))
        saver.wait()
    stream.close()
    return {
        "final_step": int(state.step),
        "losses": losses,
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "stragglers": len(monitor.events),
        "status": extra or "completed",
        "step_s": step_s,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--opt", type=str, default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the GPU; 'cpu' to train on the host)")
    args = ap.parse_args()
    out = train(
        args.arch,
        reduced=args.reduced,
        steps=args.steps,
        batch=args.batch,
        seq_len=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        optimizer_name=args.opt,
        lr=args.lr,
        microbatches=args.microbatches,
        seed=args.seed,
        device=args.device,
    )
    print(json.dumps({k: v for k, v in out.items() if k not in ("losses", "step_s")}, indent=1))


if __name__ == "__main__":
    main()
