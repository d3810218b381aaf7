"""Model dispatch: one uniform interface over the architecture families (the
port of ``repro.models.model``; the dense, MoE and VLM families so far).

``get_model(cfg)`` returns a :class:`Model` whose members close over the
config:

* ``param_specs``      — ParamSpec tree (``materialize`` it, then
  ``build_params`` makes the module)
* ``build_params``     — tree of tensors → ``transformer.DenseLM`` (dense,
  MoE) or ``transformer.VisionLM`` (VLM)
* ``loss_fn``          — (params, batch) → (scalar loss, metrics dict), forward only
* ``prefill_fn``       — (params, batch) → (last logits, populated cache)
* ``decode_fn``        — (params, cache, token, index) → (logits, cache)
* ``cache_specs``      — (batch, seq_len) → ParamSpec tree for the decode cache

``batch`` dicts carry ``tokens`` (and ``labels`` for the loss), and
``vision`` (B, Nv, vision_dim) for the VLM.  The MoE loss adds
``MOE_AUX_WEIGHT`` times the load-balance aux loss.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

MOE_AUX_WEIGHT = 0.01

#: Families of the reference that the port does not serve yet.
NOT_PORTED_FAMILIES = ("encdec", "zamba", "xlstm")


class Model(NamedTuple):
    cfg: ModelConfig
    param_specs: Any
    build_params: Callable[[Dict[str, Any]], torch.nn.Module]
    loss_fn: Callable[[Any, Dict[str, torch.Tensor]], tuple]
    prefill_fn: Callable[[Any, Dict[str, torch.Tensor]], tuple]
    decode_fn: Callable[[Any, Any, torch.Tensor, int], tuple]
    cache_specs: Callable[[int, int], Any]


def chunked_cross_entropy(
    x: torch.Tensor,  # (B, S, D) final hidden states
    w: torch.Tensor,  # (D, V) lm head
    labels: torch.Tensor,  # (B, S) int
    chunk: int = 1024,
) -> torch.Tensor:
    """Sequence-chunked softmax CE (mean over tokens): one (B, chunk, V)
    block of logits at a time, rounded to float32 after the product in
    ``x``'s dtype."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} must be a multiple of loss chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s, chunk):
        logits = torch.matmul(x[:, start : start + chunk], w.to(x.dtype)).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, start : start + chunk, None].long())[..., 0]
        total = total + torch.sum(lse - gold)
    return total / (b * s)


def _head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def get_model(cfg: ModelConfig) -> Model:
    cfg.validate()
    family = cfg.family
    if family in NOT_PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {family!r} family is not ported yet; it waits for the "
            "LM side (ROADMAP.md, section 1, item 5)"
        )
    if family not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown family {family!r}")

    def loss_fn(params, batch):
        x, aux, _ = T.forward_hidden(params, batch["tokens"], cfg, vision=batch.get("vision"))
        ce = chunked_cross_entropy(x, _head_weight(params, cfg), batch["labels"], cfg.loss_chunk)
        loss = ce + MOE_AUX_WEIGHT * aux if family == "moe" else ce
        return loss, {"ce": ce, "moe_aux": aux}

    def prefill_fn(params, batch):
        return T.prefill(params, batch["tokens"], cfg, vision=batch.get("vision"))

    def decode_fn(params, cache, token, index):
        return T.decode_step(params, cache, token, index, cfg)

    return Model(
        cfg=cfg,
        param_specs=T.build_param_specs(cfg),
        build_params=lambda tree: (T.VisionLM if family == "vlm" else T.DenseLM)(cfg, tree),
        loss_fn=loss_fn,
        prefill_fn=prefill_fn,
        decode_fn=decode_fn,
        cache_specs=lambda b, s: T.init_cache_specs(cfg, b, s),
    )
