#!/usr/bin/env python3
"""Compare the LM serve path of two checkouts of this repository on one GPU.

Run from the repository root on a machine with an NVIDIA H100, with the
other checkout unpacked in a directory of its own (``git archive``)::

    python3 serve_compare.py PARENT_DIR CHANGE_DIR

Each checkout runs in its own process (``PYTHONPATH`` at its ``src``), in
the order parent, change, change, parent.  A process builds each arch at
full width as ``serve(..., reduced=False)`` builds it (bf16 weights and
prompts from one CPU generator seeded by ``--seed``) and serves
``chip_smoke.py`` phase 15's batches through ``launch.serve.serve_prompts``
(the daemon): qwen2-1.5b's and granite-moe-3b-a800m's 4 × 32-token
prompts with 16 new tokens and their 128 × 512 with 64, zamba2-2.7b's and
xlstm-1.3b's 4 × 256 with 16 (``--archs`` picks some of them).  After one
cold serve it times ``--repeats`` warm ones and prints one JSON line per
(run, arch, batch): the decode step's ms (decode seconds over the new
tokens but the first, the median serve's) and the tokens/s of that serve,
with every serve's.  The last line is ``{"ok": true, ...}``.  About eight
minutes for qwen2, zamba and xlstm, six for granite alone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: (arch, requests, prompt length, new tokens): phase 15's serve batches.
SERVES = (("qwen2-1.5b", 4, 32, 16), ("qwen2-1.5b", 128, 512, 64),
          ("granite-moe-3b-a800m", 4, 32, 16), ("granite-moe-3b-a800m", 128, 512, 64),
          ("zamba2-2.7b", 4, 256, 16), ("xlstm-1.3b", 4, 256, 16))


def child(label: str, seed: int, repeats: int, archs) -> None:
    """Serve ``archs``' batches of ``SERVES`` with the ``repro_torch`` found
    on ``sys.path``."""
    import torch

    from repro_torch.engine.adapters import LMEngineSolver
    from repro_torch.launch import serve as launch_serve

    if not torch.cuda.is_available():
        raise SystemExit("serve_compare: no GPU")
    for arch in archs:
        gen = torch.Generator().manual_seed(seed)
        lm = LMEngineSolver(arch, gen, reduced=False, device="cuda")
        for _, batch, prompt_len, new in (s for s in SERVES if s[0] == arch):
            prompts = launch_serve.draw_prompts(lm.cfg.vocab, batch, prompt_len, gen)
            launch_serve.serve_prompts(lm, prompts, new, gen)  # cold
            runs = []
            for _ in range(repeats):
                lm.timings.clear()
                launch_serve.serve_prompts(lm, prompts, new, gen)
                decode_s = sum(t["decode_s"] for t in lm.timings)
                runs.append((decode_s * 1e3 / max(new - 1, 1), batch * new / decode_s))
            runs.sort()
            step_ms, tokens_per_s = runs[len(runs) // 2]
            print(json.dumps({"run": label, "arch": arch, "requests": batch,
                              "prompt_len": prompt_len, "new_tokens": new,
                              "decode_step_ms": step_ms, "tokens_per_s": tokens_per_s,
                              "each_decode_step_ms": [r[0] for r in runs]}), flush=True)
        del lm
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--archs", default=",".join(dict.fromkeys(a for a, *_ in SERVES)),
                    help="comma-separated archs of SERVES (default: all)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    archs = args.archs.split(",")
    unknown = set(archs) - {a for a, *_ in SERVES}
    if unknown:
        raise SystemExit(f"serve_compare: no serve batches for {sorted(unknown)}")
    if args.child is not None:
        child(args.child, args.seed, args.repeats, archs)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    order = (("parent", args.parent), ("change", args.change),
             ("change", args.change), ("parent", args.parent))
    for i, (label, root) in enumerate(order):
        src = os.path.join(os.path.abspath(root), "src")
        if not os.path.isdir(os.path.join(src, "repro_torch")):
            raise SystemExit(f"serve_compare: no src/repro_torch under {root}")
        env = dict(os.environ, PYTHONPATH=src)
        subprocess.run([sys.executable, os.path.abspath(__file__), args.parent, args.change,
                        "--seed", str(args.seed), "--repeats", str(args.repeats),
                        "--archs", args.archs, "--child", f"{label}_{i}"], env=env, check=True)
    print(json.dumps({"ok": True, "device": smi}), flush=True)


if __name__ == "__main__":
    main()
