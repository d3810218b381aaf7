"""The LM parity rule: how two implementations of one LM are held to each
other when greedy tokens may flip at near-ties.

The held quantity is the logits under teacher forcing on the port's own
greedy stream.  Both sides are fed the port's prompts and generated tokens
(step 0: the prefill logits; step t ≥ 1: the decode logits after consuming
token t − 1 at index prompt_len + t − 1), and at every step, for every row:

* ``|ℓ_port − ℓ_ref|∞ ≤ τ``;
* the port's token is the argmax of its own logits (the stream is its greedy
  stream);
* ``ℓ_ref[port token] ≥ max ℓ_ref − τ``: each port token is a reference
  argmax up to τ;
* the tokens are equal (``==``) wherever the reference's top-2 margin
  exceeds 2τ.

τ is relative to s = max_v |ℓ_ref[v]| of the row at that step, over the
vocabulary's columns (a padded vocabulary's extra columns, masked to −1e30
on both sides, are left out of s):

* float32: τ = 8 · (L + 2) · 2⁻²³ · s — a few float32 ulps for each of the
  L layers and the embedding and head.  The products' float32 sums run in
  another order in each library (XLA, torch on the CPU, cuBLAS), and the
  transcendentals (rsqrt, exp, sin, cos, pow) differ by ulps, each
  contributing a few ulps relative per layer.
* bfloat16: τ = (2⁻⁷ + 2⁻⁶ · √L) · s — one bf16 ulp of the largest logit
  for the final rounding of the logits (the ulp of s is at most 2⁻⁷ · s),
  plus a random walk of a few bf16 roundings per layer (2⁻⁸ each): the
  port rounds after every op, XLA on the CPU may keep float32 between
  fused ops, and cuBLAS on the card may reduce split-K partial sums in
  bf16 (``allow_bf16_reduced_precision_reduction``, True by default).

L is :func:`depth` of the config: the layers a token passes through (an
enc-dec model's encoder and decoder layers; Zamba's Mamba layers and its
shared block's invocations; every other family's ``n_layers``).

Both are fixed before any comparison; a row that misses its τ is a port
fault (ROADMAP.md, section 3), recorded with its inputs, never a reason to
pick another seed.  A MoE's routing can flip at a near-tie of its router
logits, which moves a token by far more than τ: ``tests/moe_rule.py``
holds MoE runs, applying this rule to each row's steps before its first
tie-bound routing.  Used by ``tests/test_torch_lm.py``, ``tests/
test_torch_lm_encdec.py``, ``tests/test_torch_lm_ssm.py`` and ``tests/
test_torch_lm_serve.py`` (port against ``repro``), ``tests/
test_torch_cuda.py`` and ``chip_smoke.py`` (card against CPU); imports
numpy and torch only.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch


#: Logits at or below this are a padded vocabulary's masked columns.
MASKED = -1e29


def depth(cfg) -> int:
    """The L the rule uses for ``cfg``: ``n_encoder_layers + n_layers`` for
    enc-dec (64 at whisper-large-v3's full width), ``n_layers + n_layers //
    shared_attn_every`` for Zamba (63: 54 Mamba layers and 9 shared
    invocations), ``n_layers`` for every other family."""
    if cfg.family == "encdec":
        return cfg.n_encoder_layers + cfg.n_layers
    if cfg.family == "zamba":
        return cfg.n_layers + cfg.n_layers // cfg.shared_attn_every
    return cfg.n_layers


def tau(dtype: str, n_layers: int, scale: np.ndarray) -> np.ndarray:
    """The rule's bound for logits whose reference magnitude is ``scale``."""
    if dtype == "float32":
        return 8.0 * (n_layers + 2) * 2.0**-23 * scale
    if dtype == "bfloat16":
        return (2.0**-7 + 2.0**-6 * math.sqrt(n_layers)) * scale
    raise ValueError(f"no LM rule for dtype {dtype!r}")


def ratios(logits_a, logits_b, dtype: str, n_layers: int) -> np.ndarray:
    """|Δlogits|∞ / τ per (row, step) of two (B, T, V) logits, ``logits_b``
    (the reference) setting the scale: the rule's first condition, as a
    measurement."""
    a = np.asarray(logits_a, dtype=np.float32)
    b = np.asarray(logits_b, dtype=np.float32)
    scale = np.where(b > MASKED, np.abs(b), 0.0).max(axis=-1)
    return np.abs(a - b).max(axis=-1) / tau(dtype, n_layers, scale)


def stream_logits(model, params, prompts, stream, vision=None, frames=None) -> np.ndarray:
    """(B, T, V) float32 logits of a port ``Model`` on ``params`` teacher-
    forced on ``stream`` (B, T) after ``prompts`` (B, L) (and a VLM's
    ``vision`` (B, Nv, vision_dim), an enc-dec model's ``frames`` (B, T_enc,
    d_model)), on the params' device, with the shapes ``make_generate`` uses
    for T new tokens."""
    from repro_torch.models import params as P
    from repro_torch.models.steps import graft_cache

    dev = params.device
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32, device=dev)
    stream = torch.as_tensor(np.asarray(stream), dtype=torch.int32, device=dev)
    b, length = prompts.shape
    steps = stream.shape[1]
    batch = {"tokens": prompts}
    if vision is not None:
        batch["vision"] = torch.as_tensor(vision).to(dev)
    if frames is not None:
        batch["frames"] = torch.as_tensor(frames).to(dev)
    with torch.inference_mode():
        logits, prefill_cache = model.prefill_fn(params, batch)
        out = [logits.float().cpu()]
        cache = graft_cache(P.materialize(model.cache_specs(b, length + steps), None, dev),
                            prefill_cache)
        for t in range(1, steps):
            logits, cache = model.decode_fn(params, cache, stream[:, t - 1 : t], length + t - 1)
            out.append(logits.float().cpu())
    return torch.stack(out, dim=1).numpy()


def hold(
    tokens, port_logits, ref_logits, dtype: str, n_layers: int, what: str = ""
) -> Dict[str, Any]:
    """Apply the rule to the port's ``tokens`` (B, T) and both sides' (B, T,
    V) teacher-forced logits; raises ``AssertionError`` naming the first
    miss, else returns a summary: the largest |Δℓ| / τ, the steps where the
    reference's margin demanded equal tokens, and the port tokens that are
    not the reference's argmax (ties within τ)."""
    tokens = np.asarray(tokens).astype(np.int64)
    port = np.asarray(port_logits, dtype=np.float32)
    ref = np.asarray(ref_logits, dtype=np.float32)
    if not (port.shape == ref.shape and port.shape[:2] == tokens.shape):
        raise AssertionError(f"{what}: shapes {tokens.shape}, {port.shape}, {ref.shape}")
    scale = np.where(ref > MASKED, np.abs(ref), 0.0).max(axis=-1)  # (B, T)
    bound = tau(dtype, n_layers, scale)
    diff = np.abs(port - ref).max(axis=-1)
    worst = np.unravel_index(np.argmax(diff / bound), diff.shape)
    if not np.all(diff <= bound):
        raise AssertionError(f"{what}: |Δlogits| {diff[worst]} > τ {bound[worst]} at (row, step) "
                             f"{tuple(int(i) for i in worst)}")
    own = port.argmax(axis=-1)
    if not np.array_equal(own, tokens):
        bad = np.argwhere(own != tokens)[0]
        raise AssertionError(f"{what}: token {tokens[tuple(bad)]} is not the port's own argmax "
                             f"{own[tuple(bad)]} at (row, step) {tuple(int(i) for i in bad)}")
    picked = np.take_along_axis(ref, tokens[..., None], axis=-1)[..., 0]
    if not np.all(picked >= ref.max(axis=-1) - bound):
        bad = np.argwhere(picked < ref.max(axis=-1) - bound)[0]
        raise AssertionError(f"{what}: token at (row, step) {tuple(int(i) for i in bad)} is more "
                             "than τ below the reference's maximum")
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * bound
    ref_arg = ref.argmax(axis=-1)
    if not np.array_equal(tokens[decided], ref_arg[decided]):
        bad = np.argwhere(decided & (tokens != ref_arg))[0]
        raise AssertionError(f"{what}: token differs from the reference's at (row, step) "
                             f"{tuple(int(i) for i in bad)} where its margin exceeds 2τ")
    return {
        "dtype": dtype,
        "max_diff_over_tau": float((diff / bound).max()),
        "max_abs_diff": float(diff.max()),
        "steps_decided": int(decided.sum()),
        "steps": int(decided.size),
        "tokens_not_ref_argmax": int((tokens != ref_arg).sum()),
    }
