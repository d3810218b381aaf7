#!/usr/bin/env python3
"""How far xlstm-1.3b at full width amplifies rounding differences, on one
GPU (ROADMAP.md section 3, port fault 5).

Run from the repository root on a machine with an NVIDIA H100::

    python3 xlstm_sensitivity.py [--seed 0]

It builds xlstm-1.3b at full width as ``serve(..., reduced=False)`` builds
it (bf16 weights and 4 × 256-token prompts from one CPU generator seeded by
``--seed``), takes the card's greedy stream of 16 tokens, and prints JSON
lines of the LM rule's |Δlogits| / τ (``tests/lm_rule.py``, depth 48) per
(row, step), teacher-forced on that stream:

1. ``bf16``: the card against a CPU copy of the same weights;
2. ``bf16_no_reduced_precision_reduction``: the same with cuBLAS's bf16
   reduced-precision reduction off, and whether any card logit moved;
3. ``float32``: a float32 model on the same bf16 weights, card against CPU
   (τ of float32);
4. ``sensitivity``: each device's bf16 run against its own float32 run;
5. ``blocks``: at the worst (row, step) of line 1, the relative difference
   of the hidden state, card against CPU, after each of the 48 blocks of
   that decode step (each side on its own caches).

The last line is ``{"ok": true, ...}``.  A few minutes, most of them on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))


def extremes(value: np.ndarray) -> dict:
    return {"max": float(value.max()), "min": float(value.min())}


def emit(name: str, value) -> None:
    """One JSON line; an array of ratios as its extremes and its values."""
    if isinstance(value, np.ndarray):
        value = {**extremes(value), "per_row_step": np.round(value, 3).tolist()}
    print(json.dumps({"line": name, **value}), flush=True)


def block_trace(lm, params, prompts, stream, step: int, device) -> list:
    """The hidden state (float32, on the CPU) after each block of decode step
    ``step`` of the teacher-forced run, on ``params``' own caches."""
    from repro_torch.models import layers as L
    from repro_torch.models import params as PM
    from repro_torch.models import xlstm as X
    from repro_torch.models.steps import graft_cache

    model, cfg = lm.model, lm.cfg
    b, length = prompts.shape
    tokens = stream.to(device)
    out = []
    with torch.inference_mode():
        _, prefill_cache = model.prefill_fn(params, {"tokens": prompts.to(device)})
        cache = graft_cache(PM.materialize(model.cache_specs(b, length + stream.shape[1]), None,
                                           device), prefill_cache)
        for t in range(1, step):
            _, cache = model.decode_fn(params, cache, tokens[:, t - 1 : t], length + t - 1)
        x = params["embed"][tokens[:, step - 1 : step]].to(torch.bfloat16)
        for g, (group, sp) in enumerate(zip(params["mblocks"], params["sblocks"])):
            for j, lp in enumerate(group):
                h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
                mc = X.MLSTMCache(cache["m_conv"][g, j], cache["m_state"][g, j])
                x = x + X.mlstm_decode_step(lp["mlstm"], h, mc, cfg)[0]
                out.append(x.float().cpu())
            h = L.rms_norm(x, sp["ln"], cfg.norm_eps)
            cell = X.SLSTMCache(cache["s_c"][g], cache["s_n"][g], cache["s_h"][g])
            x = x + X.slstm_decode_step(sp["slstm"], h, (cache["s_conv"][g], cell), cfg)[0]
            out.append(x.float().cpu())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("xlstm_sensitivity: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    from lm_rule import depth, ratios, stream_logits
    from repro_torch.engine.adapters import LMEngineSolver
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import get_model
    from repro_torch.models.steps import make_generate

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    lm = LMEngineSolver("xlstm-1.3b", gen, reduced=False, device=dev)
    cfg, n = lm.cfg, depth(lm.cfg)
    prompts = launch_serve.draw_prompts(cfg.vocab, 4, 256, gen)
    stream, _ = make_generate(lm.model)(lm.params, {"tokens": prompts}, 16)
    cpu = copy.deepcopy(lm.params).to("cpu")

    card = stream_logits(lm.model, lm.params, prompts, stream)
    host = stream_logits(lm.model, cpu, prompts, stream)
    bf16 = ratios(card, host, "bfloat16", n)
    emit("bf16", bf16)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card_exact = stream_logits(lm.model, lm.params, prompts, stream)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    emit("bf16_no_reduced_precision_reduction",
         {**extremes(ratios(card_exact, host, "bfloat16", n)),
          "card_logits_moved": bool(np.any(card_exact != card))})
    model32 = get_model(dataclasses.replace(cfg, dtype="float32"))
    card32 = stream_logits(model32, lm.params, prompts, stream)
    host32 = stream_logits(model32, cpu, prompts, stream)
    emit("float32", ratios(card32, host32, "float32", n))
    emit("sensitivity", {"card_bf16_vs_float32": extremes(ratios(card, card32, "bfloat16", n)),
                         "cpu_bf16_vs_float32": extremes(ratios(host, host32, "bfloat16", n))})
    row, step = (int(i) for i in np.unravel_index(np.argmax(bf16), bf16.shape))
    step = max(step, 1)
    on_card = block_trace(lm, lm.params, prompts, stream, step, dev)
    on_cpu = block_trace(lm, cpu, prompts, stream, step, torch.device("cpu"))
    growth = [float((a[row] - b[row]).abs().max() / b[row].abs().max())
              for a, b in zip(on_card, on_cpu)]
    factor = (growth[-1] / growth[0]) ** (1 / (len(growth) - 1)) if growth[0] else None
    emit("blocks", {"row": row, "step": step, "relative_difference_after_block": growth,
                    "per_block_factor": factor})
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
