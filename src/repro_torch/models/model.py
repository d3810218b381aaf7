"""Model dispatch: one uniform interface over the six architecture families
(the port of ``repro.models.model``): dense, MoE, VLM, enc-dec, Zamba and
xLSTM.

``get_model(cfg)`` returns a :class:`Model` whose members close over the
config:

* ``param_specs``      — ParamSpec tree (``materialize`` it, then
  ``build_params`` makes the module)
* ``build_params``     — tree of tensors → ``transformer.DenseLM`` (dense,
  MoE), ``transformer.VisionLM`` (VLM), ``encdec.EncDecLM``,
  ``hybrid.ZambaLM`` or ``hybrid.XLSTMLM``
* ``loss_fn``          — (params, batch) → (scalar loss, metrics dict), forward only
* ``prefill_fn``       — (params, batch) → (last logits, populated cache)
* ``decode_fn``        — (params, cache, token, index) → (logits, cache)
* ``cache_specs``      — (batch, seq_len) → ParamSpec tree for the decode cache

``batch`` dicts carry ``tokens`` (and ``labels`` for the loss), ``vision``
(B, Nv, vision_dim) for the VLM and ``frames`` (B, T_enc, d_model) for the
enc-dec family.  The MoE loss adds ``MOE_AUX_WEIGHT`` times the
load-balance aux loss.  The enc-dec decode cache holds
``ENCDEC_DECODE_MEMORY_LEN`` cross-attention slots whatever T_enc (reference
fault 7, ROADMAP.md section 3); Zamba and xLSTM take prompts of whole SSD
chunks (``ssm_chunk``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.models import encdec as E
from repro_torch.models import hybrid as H
from repro_torch.models import layers as L
from repro_torch.models import tp
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

MOE_AUX_WEIGHT = 0.01

#: Encoder memory length of the enc-dec decode cache: Whisper's 30 s window
#: (1500 frames); the decode length applies to the decoder's self cache.
ENCDEC_DECODE_MEMORY_LEN = 1500
#: Decoder prompt length of the enc-dec prefill cells (task/prompt tokens).
ENCDEC_PREFILL_PROMPT_LEN = 16


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
    parts: int = 1,
) -> torch.Tensor:
    """Sequence-chunked softmax CE (mean over tokens): one (B, chunk, V)
    block of logits at a time, rounded to float32 after the product in
    ``x``'s dtype.  Under autograd each chunk's logits are recomputed in
    the backward pass (``layers.remat``), as the reference's are.

    ``parts`` > 1: ``w`` holds this device's block of the vocab columns (a
    device's program, ``models/tp.py``): each block's log-sum-exp is
    gathered and combined, and the label's logit summed from the block
    that holds it."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} must be a multiple of loss chunk {chunk}")

    def body(xc, yc):
        if parts > 1:
            xc = tp.enter(xc)
        logits = torch.matmul(xc, w.to(x.dtype)).float()
        lse = torch.logsumexp(logits, dim=-1)
        if parts > 1:
            v = w.shape[-1]
            local = yc.long() - tp.rank() * v
            inside = (local >= 0) & (local < v)
            gold = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
            gold = tp.reduce(gold * inside)
            lse = torch.logsumexp(tp.gather(lse[None], 0), dim=0)
            return torch.sum(lse - gold)
        gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
        return torch.sum(lse - gold)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s, chunk):
        total = total + L.remat(body, x[:, start : start + chunk],
                                labels[:, start : start + chunk])
    return total / (b * s)


def _head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.family == "encdec" or cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _head_parts(params, cfg: ModelConfig) -> int:
    """The vocab blocks of :func:`_head_weight` in a device's program."""
    if cfg.family == "encdec" or cfg.tie_embeddings:
        return tp.parts(params, "embed", 0)
    return tp.parts(params, "lm_head", 1)


def _cross_entropy(params, x, batch, cfg: ModelConfig) -> torch.Tensor:
    return chunked_cross_entropy(x, _head_weight(params, cfg), batch["labels"], cfg.loss_chunk,
                                 _head_parts(params, cfg))


def _no_aux(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def get_model(cfg: ModelConfig) -> Model:
    cfg.validate()
    family = cfg.family
    if family == "encdec":
        return _encdec_model(cfg)
    if family in ("zamba", "xlstm"):
        return _recurrent_model(cfg)
    if family not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown family {family!r}")

    def loss_fn(params, batch):
        x, aux, _ = T.forward_hidden(params, batch["tokens"], cfg, vision=batch.get("vision"))
        ce = _cross_entropy(params, x, batch, cfg)
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


def _encdec_model(cfg: ModelConfig) -> Model:
    def loss_fn(params, batch):
        memory = E.encode(params, batch["frames"], cfg)
        x, _ = E.decode_sequence(params, memory, batch["tokens"], cfg)
        ce = _cross_entropy(params, x, batch, cfg)
        return ce, {"ce": ce, "moe_aux": _no_aux(ce.device)}

    return Model(
        cfg=cfg,
        param_specs=E.build_param_specs(cfg),
        build_params=lambda tree: E.EncDecLM(cfg, tree),
        loss_fn=loss_fn,
        prefill_fn=lambda p, b: E.prefill(p, b["frames"], b["tokens"], cfg),
        decode_fn=lambda p, c, t, i: E.decode_step(p, c, t, i, cfg),
        cache_specs=lambda b, s: E.init_cache_specs(cfg, b, s, ENCDEC_DECODE_MEMORY_LEN),
    )


def _recurrent_model(cfg: ModelConfig) -> Model:
    """Zamba or xLSTM: the same five members over their own assembly."""
    zamba = cfg.family == "zamba"
    forward_hidden = H.zamba_forward_hidden if zamba else H.xlstm_forward_hidden
    prefill = H.zamba_prefill if zamba else H.xlstm_prefill
    decode = H.zamba_decode_step if zamba else H.xlstm_decode_step
    cache_specs = H.zamba_cache_specs if zamba else H.xlstm_cache_specs

    def loss_fn(params, batch):
        x, _ = forward_hidden(params, batch["tokens"], cfg)
        ce = _cross_entropy(params, x, batch, cfg)
        return ce, {"ce": ce, "moe_aux": _no_aux(ce.device)}

    return Model(
        cfg=cfg,
        param_specs=(H.zamba_param_specs if zamba else H.xlstm_param_specs)(cfg),
        build_params=lambda tree: (H.ZambaLM if zamba else H.XLSTMLM)(cfg, tree),
        loss_fn=loss_fn,
        prefill_fn=lambda p, b: prefill(p, b["tokens"], cfg),
        decode_fn=lambda p, c, t, i: decode(p, c, t, i, cfg),
        cache_specs=lambda b, s: cache_specs(cfg, b, s),
    )
