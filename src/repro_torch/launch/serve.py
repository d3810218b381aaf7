"""LM serving CLI: prompts through the continuous serving daemon (the port of
``repro.launch.serve``; every family: dense, MoE, VLM, enc-dec, Zamba and
xLSTM).

Each prompt is submitted as one engine request; the ``lm`` adapter runs
prefill + the token-by-token decode loop
(``repro_torch.models.steps.make_generate``).  By default requests flow
through the serving stack — :class:`repro_torch.serving.ContinuousEngine`
fair queues + scheduler ticks driven by a
:class:`repro_torch.serving.ServeDaemon` — so batching, bucketing and flush
policy live in one place (the scheduler), not in this launcher.  ``--once``
keeps the one-shot path: a plain engine ``drain()``.

Randomness is explicit end to end: one CPU ``torch.Generator`` seeded by
``--seed`` draws the weights (``params.materialize``), then the prompts
(:func:`draw_prompts`), then, for a VLM, every request's (n_vision_tokens,
vision_dim) bf16 patch embeddings (:func:`draw_vision`), or for the enc-dec
family every request's (prompt_len, d_model) bf16 frame embeddings
(:func:`draw_frames`), then roots the engine (:func:`serve_prompts`).
Zamba and xLSTM take prompts of whole SSD chunks: ``--prompt`` a multiple of
``ssm_chunk`` (16 reduced, 256 at full width), else the launcher raises
before drawing anything.
Token accounting (see ``make_generate``): the returned stream always holds
exactly ``max_new_tokens`` tokens — token 0 from the prefill logits, token
i from the i-th decode step.  It runs on the card unless ``--device cpu``.
The CLI serves the reduced config; ``serve(..., reduced=False)`` serves the
full width.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch qwen2-1.5b --tokens 5
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch granite-moe-3b-a800m
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch llama-3.2-vision-11b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch whisper-large-v3
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch zamba2-2.7b --prompt 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch xlstm-1.3b --prompt 16
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.engine import Engine, Request
from repro_torch.engine.adapters import LMEngineSolver
from repro_torch.models.ssm import check_chunks
from repro_torch.serving import ContinuousEngine, ServeDaemon


def draw_prompts(
    vocab: int, batch: int, prompt_len: int, generator: torch.Generator
) -> torch.Tensor:
    """(batch, prompt_len) int32 token ids uniform in [0, vocab), drawn from
    the CPU ``generator``; on the CPU."""
    return torch.randint(0, vocab, (batch, prompt_len), generator=generator, dtype=torch.int32)


def draw_vision(n_vision_tokens: int, vision_dim: int, batch: int,
                generator: torch.Generator) -> torch.Tensor:
    """(batch, n_vision_tokens, vision_dim) standard normal patch embeddings
    in bf16 (a VLM request's ``vision``), drawn from the CPU ``generator``;
    on the CPU."""
    draw = torch.randn((batch, n_vision_tokens, vision_dim), generator=generator)
    return draw.to(torch.bfloat16)


def draw_frames(prompt_len: int, d_model: int, batch: int,
                generator: torch.Generator) -> torch.Tensor:
    """(batch, prompt_len, d_model) standard normal frame embeddings in bf16
    (an enc-dec request's ``frames``: as many frames as prompt tokens, as the
    reference draws them), from the CPU ``generator``; on the CPU."""
    return torch.randn((batch, prompt_len, d_model), generator=generator).to(torch.bfloat16)


def serve_prompts(
    lm: LMEngineSolver,
    prompts: torch.Tensor,
    max_new_tokens: int,
    generator: torch.Generator,
    *,
    vision: Optional[torch.Tensor] = None,
    frames: Optional[torch.Tensor] = None,
    once: bool = False,
) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Serve each row of ``prompts`` (with its row of ``vision`` for a VLM,
    of ``frames`` for an enc-dec model) as one request of ``lm`` on an
    engine rooted at the CPU ``generator`` (a ``ServeDaemon`` over a
    ``ContinuousEngine``, or with ``once`` one ``Engine.drain``).  Returns
    (report, tokens): the reference's report plus ``device``, and every
    request's (max_new_tokens,) result stacked, on the CPU."""
    batch, prompt_len = prompts.shape
    eng = (Engine if once else ContinuousEngine)(generator, device=lm.device)
    eng.install("lm", lm)
    futures = []
    for i in range(batch):
        payload: Dict[str, Any] = {"tokens": prompts[i], "max_new_tokens": max_new_tokens}
        if vision is not None:
            payload["vision"] = vision[i]
        if frames is not None:
            payload["frames"] = frames[i]
        futures.append(eng.submit(Request("lm", payload)))

    t0 = time.perf_counter()
    if once:
        stats = eng.drain()
    else:
        # Daemon path: scheduler ticks own all batching/flush decisions.
        # The source is already closed, so the daemon ticks until idle —
        # the launcher owns signals here (signals=()).
        ServeDaemon(eng, signals=()).run(iter(()))
        stats = eng.stats()
    wall = time.perf_counter() - t0

    tokens_out = torch.stack([f.result() for f in futures])
    if tuple(tokens_out.shape) != (batch, max_new_tokens):
        raise RuntimeError(
            f"engine returned token array {tuple(tokens_out.shape)}, expected "
            f"({batch}, {max_new_tokens})"
        )
    # A drain may execute several slabs (batch > largest bucket); sum their
    # timings so throughput covers every served lane, not just the last slab.
    prefill_s = sum(t.get("prefill_s", 0.0) for t in lm.timings)
    decode_s = sum(t.get("decode_s", 0.0) for t in lm.timings)
    return {
        "arch": lm.arch,
        "batch": batch,
        "prompt_len": prompt_len,
        "new_tokens": tokens_out.shape[1],
        "prefill_s": round(prefill_s, 3),
        "decode_s": round(decode_s, 3),
        "wall_s": round(wall, 3),
        "tokens_per_s": round(batch * tokens_out.shape[1] / max(decode_s, 1e-9), 1),
        "sample": tokens_out[0, :8].tolist(),
        "engine": {
            "slabs": stats["slabs"],
            "pad_fraction": round(stats["pad_fraction"], 3),
        },
        "device": str(lm.device),
    }, tokens_out


def serve(
    arch: str,
    *,
    reduced: bool = True,
    batch: int = 4,
    prompt_len: int = 32,
    max_new_tokens: int = 16,
    seed: int = 0,
    once: bool = False,
    device=None,
) -> Dict[str, Any]:
    """Serve ``batch`` random prompts of ``arch`` (its reduced config unless
    ``reduced=False``) with random weights, all drawn from one CPU generator
    seeded by ``seed``, on ``device`` (the GPU unless ``"cpu"``); returns
    :func:`serve_prompts`' report.  A Zamba or xLSTM ``prompt_len`` that is
    not a multiple of ``ssm_chunk`` raises ``ValueError`` first."""
    cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
    if cfg.family in ("zamba", "xlstm"):
        check_chunks(prompt_len, cfg)
    gen = torch.Generator().manual_seed(seed)
    lm = LMEngineSolver(arch, gen, reduced=reduced, device=device)
    prompts = draw_prompts(cfg.vocab, batch, prompt_len, gen)
    vision = frames = None
    if cfg.family == "vlm":
        vision = draw_vision(cfg.n_vision_tokens, cfg.vision_dim, batch, gen)
    if cfg.family == "encdec":
        frames = draw_frames(prompt_len, cfg.d_model, batch, gen)
    return serve_prompts(lm, prompts, max_new_tokens, gen, vision=vision, frames=frames,
                         once=once)[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--once", action="store_true",
                    help="one-shot engine drain instead of the serving daemon")
    ap.add_argument("--device", default=None, help="'cpu' to serve on the CPU (default: the GPU)")
    args = ap.parse_args()
    print(json.dumps(serve(args.arch, batch=args.batch, prompt_len=args.prompt,
                           max_new_tokens=args.tokens, seed=args.seed,
                           once=args.once, device=args.device), indent=1))


if __name__ == "__main__":
    main()
