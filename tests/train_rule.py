"""The training parity rule: how a train step of the port is held to the
reference's (or the card's to the CPU's).

The loss and gradient clauses were written before any comparison.  The
optimizer clauses were amended after the first comparisons (the ulp's
magnitude, the summation-order term, the bf16-leaf and zero-gradient
clauses), and again once a summation-order term scaled by the parameter's
magnitude was found to let a no-op update pass: it now scales the term
that carries the error, and the tests show that a no-op and a per-block
Adafactor clip fail it.  A miss is a port fault (ROADMAP.md,
section 3), recorded with its inputs, never a reason to pick another seed.

* Loss, float32 activations: |Δ| ≤ 1e-5 · |loss|.
* Gradient leaf, float32 activations: ‖Δg‖₂ ≤ 1e-4 · ‖g‖₂ for a float32
  leaf (a MoE router, the SSM's ``a_log``/``d_skip``/``dt_bias``, the
  mLSTM's gate weights).  A bf16 parameter's gradient is a bf16 leaf on
  both sides: each rounds its float32 gradient to bf16 once, and two
  roundings to nearest of values within the float32 rule differ by at most
  one bf16 ulp (≤ 2⁻⁷ of the element), so such a leaf is held to
  ‖Δg‖₂ ≤ (1e-4 + 2⁻⁷) · ‖g‖₂.
  A leaf whose gradient is zero in exact arithmetic holds rounding noise
  on both sides: the key bias of an attention without RoPE (the enc-dec's
  self-attention: softmax is invariant to a shift shared by every key of a
  query).  Each side's ‖g‖₂ is then held to 1e-4 · ‖g_wk‖₂, the gradient
  of the same layers' key projection, fed by the same ∂L/∂k.
* bf16 activations: the loss within the LM rule's bf16 τ shape
  (2⁻⁷ + 2⁻⁶ · √L) · |loss| (``lm_rule.tau`` at L = ``lm_rule.depth``),
  and the total gradient norm (all leaves) within 2⁻⁵ of the reference's:
  |‖g‖₂ − ‖g_ref‖₂| ≤ 2⁻⁵ · ‖g_ref‖₂.
* Optimizer on identical inputs (the same gradients, state and params),
  elementwise: a float32 value within 4 float32 ulps of the reference's,
  the ulp taken at the larger magnitude of the two values plus the leaf's
  magnitude before the update (the update's last operation adds two terms,
  ``p − lr · step`` or ``b1 · m + (1 − b1) · g``, each at most that large;
  where they cancel, the result's own ulp is finer than the rounding each
  term carries).  A bf16 param is that float32 result rounded once on each
  side: within one bf16 ulp (at the larger of the two values) plus the
  float32 allowance, so at most one bf16 ulp apart; the count of differing
  elements is reported.  Where the update is below half a bf16 ulp, a bf16
  leaf cannot tell it from none: the float32 leaves carry that check.
* A float32 sum of n non-negative terms S (the global norm's sum of
  squares) taken in another order: each side's error is at most
  γ_{n−1} · S (γ_k = k·u / (1 − k·u), u = 2⁻²⁴, the bound of any summation
  tree), so the norms √S differ by at most γ_{n−1} relative (plus 4 ulps
  for the squares and the root).  Adafactor's row and column means, the
  mean of its row statistics and its RMS are such sums over at most a
  leaf's n elements; through the square roots they move its update by at
  most 4γ_n relative.  Such a relative error ``rel`` is allowed on the term
  that carries it, never on the whole leaf: a parameter's update
  |p_new − p| (plus lr · weight decay · |p|, the update's part that no
  reduction feeds), a state leaf's new term (at most |new| + |old|), or a
  whole value (a norm, a clipped gradient, a state made from zero).  A
  clip whose scale is exactly 1 (global norm below the clip norm) adds no
  error.

An ulp here is the spacing of the dtype (float32: 2^(⌊log₂|x|⌋ − 23), as
``np.spacing``; bf16: 2^(⌊log₂|x|⌋ − 7)).  Comparisons run in float64 on
the device of the first side's tensors.  Used by
``tests/test_torch_lm_train.py``, ``tests/test_torch_optim.py``,
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; imports numpy, torch
and (in its card-against-CPU helpers) ``repro_torch``, never ``jax``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

LOSS_F32 = 1e-5
GRAD_F32 = 1e-4
BF16_ROUNDING = 2.0**-7
GRAD_NORM_BF16 = 2.0**-5
OPT_F32_ULPS = 4
U32 = 2.0**-24


def gamma(k: int) -> float:
    """γ_k = k·u / (1 − k·u): the relative error bound of a float32 sum of
    k + 1 non-negative terms in any order."""
    return k * U32 / (1.0 - k * U32)


def as_f64(x) -> np.ndarray:
    """A tensor or array (bf16 included) as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float64).numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32).astype(np.float64)
    return a.astype(np.float64)


def dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def hold_loss(got: float, want: float, dtype: str, depth: int, what: str = "") -> float:
    """The loss rule; returns |Δ| over its bound."""
    if dtype == "float32":
        bound = LOSS_F32 * abs(want)
    else:
        bound = (2.0**-7 + 2.0**-6 * math.sqrt(depth)) * abs(want)
    ratio = abs(got - want) / bound
    assert ratio <= 1.0, f"{what}: loss {got} against {want}, |Δ| over its bound {ratio}"
    return ratio


def _t64(x, device=None) -> torch.Tensor:
    """A tensor or array (bf16 included) as a float64 tensor on ``device``
    (by default the tensor's own, the CPU for an array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device or x.device).to(torch.float64)
    return torch.from_numpy(as_f64(x)).to(device or "cpu")


def _device(x):
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _norm(x, device=None) -> float:
    return float(torch.linalg.vector_norm(_t64(x, device)))


def hold_grads(got: Dict[str, object], want: Dict[str, object], dtype: str,
               what: str = "", zero: Dict[str, str] = None) -> Dict[str, float]:
    """The gradient rule over two {path: leaf} dicts of the same paths;
    returns each leaf's ‖Δg‖₂ over its bound (float32 activations) or the
    total norm's |Δ| over its bound (bf16 activations), under ``"total"``.
    ``zero``: {path of a leaf zero in exact arithmetic: path of the leaf
    whose gradient norm scales it}.  Computed in float64 on the device of
    ``got``'s leaves."""
    zero = zero or {}
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want))[:4])
    if dtype != "float32":
        g = math.sqrt(sum(_norm(v) ** 2 for v in got.values()))
        r = math.sqrt(sum(_norm(v) ** 2 for v in want.values()))
        ratio = abs(g - r) / (GRAD_NORM_BF16 * r)
        assert ratio <= 1.0, f"{what}: gradient norm {g} against {r} (over bound {ratio})"
        return {"total": ratio}
    out = {}
    for path, scale_path in zero.items():
        bound = GRAD_F32 * _norm(want[scale_path])
        for side in (got, want):
            norm = _norm(side[path])
            assert norm <= bound, f"{what}: gradient {path} (zero) ‖g‖ {norm} > {bound}"
        out[path] = _norm(got[path]) / bound
    for path in sorted(set(want) - set(zero)):
        dev = _device(got[path])
        g, r = _t64(got[path]), _t64(want[path], dev)
        assert g.shape == r.shape, (what, path, tuple(g.shape), tuple(r.shape))
        assert dtype_name(got[path]) == dtype_name(want[path]), (what, path)
        rel = GRAD_F32 + (BF16_ROUNDING if dtype_name(want[path]) == "bfloat16" else 0.0)
        norm = float(torch.linalg.vector_norm(r))
        diff = float(torch.linalg.vector_norm(g - r))
        out[path] = diff / (rel * norm) if norm > 0 else float(diff > 0)
        assert diff <= rel * norm, (
            f"{what}: gradient {path}: ‖Δg‖ {diff} > {rel} · ‖g‖ {norm}")
    return out


def ulp(mag: torch.Tensor, dtype: str) -> torch.Tensor:
    """The spacing of ``dtype`` (float32 or bf16) at magnitudes ``mag``
    (float64): 2^(⌊log₂ mag⌋ − 23) or 2^(⌊log₂ mag⌋ − 7), at least the
    smallest normal's."""
    bits = {"float32": 23, "bfloat16": 7}[dtype]
    _, exp = torch.frexp(torch.clamp(mag, min=2.0**-126))
    return torch.ldexp(torch.ones_like(mag), exp - 1 - bits)


def hold_update(got, want, what: str = "", rel: float = 0.0, before=None,
                decay: float = 0.0, state: bool = False) -> int:
    """The optimizer rule for one leaf (module docstring); returns the count
    of elements that differ.  ``before``: the leaf before the update.
    ``rel``: a reduction's relative error, allowed on the term that carries
    it: a parameter's update |want − before| plus ``decay`` · |before|
    (``decay``: lr · weight decay); with ``state``, a state leaf's new term,
    at most |want| + |before|; without ``before``, |want|."""
    dev = _device(got)
    g, r = _t64(got), _t64(want, dev)
    assert g.shape == r.shape, (what, tuple(g.shape), tuple(r.shape))
    name = dtype_name(want)
    assert dtype_name(got) == name, (what, dtype_name(got), name)
    diff = torch.abs(g - r)
    top = torch.maximum(torch.abs(g), torch.abs(r))
    if before is None:
        mag, term = top, torch.abs(r)
    else:
        b = torch.abs(_t64(before, dev))
        mag = top + b
        term = torch.abs(r) + b if state else torch.abs(r - _t64(before, dev)) + decay * b
    allowed = OPT_F32_ULPS * ulp(mag, "float32") + rel * term
    if name == "float32":
        bad = diff > allowed
    elif name == "bfloat16":
        bad = diff > ulp(top, name) + allowed
    else:
        bad = diff > 0
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} elements outside the rule (max |Δ| {float(diff.max())})")
    return int((diff > 0).sum())


# ---------------------------------------------------------------------------
# Card against CPU (``tests/test_torch_cuda.py``, ``chip_smoke.py``)
# ---------------------------------------------------------------------------


def zero_leaves(cfg) -> Dict[str, str]:
    """The leaves whose gradient is zero in exact arithmetic, each with the
    leaf that scales it (the enc-dec's key biases: no RoPE)."""
    if cfg.family != "encdec":
        return {}
    return {"enc_blocks.attn.bk": "enc_blocks.attn.wk",
            "dec_blocks.self_attn.bk": "dec_blocks.self_attn.wk"}


def hold_step(model, card_params, cpu_params, batch, what: str = ""):
    """``value_and_grad`` of ``model`` on the card's and the CPU's copies of
    the same parameters and ``batch`` (CPU tensors), held by the loss and
    gradient rules.  Returns (summary, card grads, CPU grads)."""
    from lm_rule import depth
    from repro_torch.models import params as PP
    from repro_torch.models import steps

    dtype = model.cfg.dtype
    dev = next(leaf for _, leaf in PP.leaves(card_params)).device
    (l_card, _), g_card = steps.value_and_grad(
        model, card_params, {k: v.to(dev) for k, v in batch.items()})
    (l_cpu, _), g_cpu = steps.value_and_grad(model, cpu_params, batch)
    loss_ratio = hold_loss(float(l_card), float(l_cpu), dtype, depth(model.cfg), what)
    ratios = hold_grads(dict(PP.leaves(g_card)), dict(PP.leaves(g_cpu)), dtype, what,
                        zero_leaves(model.cfg))
    worst = max(ratios, key=ratios.get)
    return ({"loss_card": float(l_card), "loss_cpu": float(l_cpu),
             "loss_diff_over_bound": loss_ratio, "grad_leaves": len(ratios),
             "max_grad_diff_over_bound": ratios[worst], "worst_leaf": worst},
            g_card, g_cpu)


def hold_adamw_identical(card_params, cpu_params, grads, what: str = "") -> Dict[str, int]:
    """AdamW's first update (its default betas, ε and weight decay, at lr
    1e-2: an update far above the rule's allowance) on the card and on the
    CPU from identical gradients: ``grads`` (CPU) scaled to global norm ½,
    so that the clip's scale is exactly 1 on both sides.  New params, m and
    v held by the optimizer rule; returns the counts of differing
    elements."""
    from repro_torch import optim
    from repro_torch.models import params as PP

    norm = math.sqrt(sum(_norm(g) ** 2 for _, g in PP.leaves(grads)))
    scaled = PP.map_tree(lambda g: (g.double() * (0.5 / norm)).to(g.dtype), grads)
    dev = next(leaf for _, leaf in PP.leaves(card_params)).device
    opt = optim.adamw(optim.constant(1e-2))
    outs = []
    for params, g in ((card_params, PP.map_tree(lambda t: t.to(dev), scaled)),
                      (cpu_params, scaled)):
        new_p, new_s, metrics = opt.update(g, opt.init(params), params)
        assert float(metrics["grad_norm"]) <= 1.0, (what, float(metrics["grad_norm"]))
        outs.append((new_p, new_s))
    (card_p, card_s), (cpu_p, cpu_s) = outs
    before, card_flat = dict(PP.leaves(cpu_params)), dict(PP.leaves(card_p))
    counts = {"params": 0, "m": 0, "v": 0}
    for k, v in PP.leaves(cpu_p):
        counts["params"] += hold_update(card_flat[k], v, f"{what} params {k}", before=before[k])
    for part in ("m", "v"):
        card_flat = dict(PP.leaves(card_s[part]))
        for k, v in PP.leaves(cpu_s[part]):
            counts[part] += hold_update(card_flat[k], v, f"{what} {part} {k}")
    return counts
