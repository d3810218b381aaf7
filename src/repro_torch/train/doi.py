"""Batched Diederich–Opper I training with quantization awareness (the port
of ``repro.train.doi``).

The paper trains its associative memories with the DO-I rule and runs them
at 5-bit signed weights.  This trainer measures every stability check on
the weights the hardware runs when asked to (QAT):

* **Sweeps** — a Python loop over sweeps, each visiting the patterns in
  order (the original convergence prescription) and updating every
  unstable *row* of W for that pattern at once.  The loop reads one number
  from the device per sweep: whether any library still has unstable rows.
* **Library batching** — a leading ``(L, P, N)`` axis trains L independent
  pattern libraries in the same sweeps, as batched products.  A library
  that has converged (or run out of sweeps) keeps its weights and its sweep
  count while the others go on.
* **Pattern-count masking** — ``n_patterns`` deactivates trailing rows of a
  padded pattern array (per library when batched).
* **Quantization-aware training (QAT)** — with ``qat_bits > 0`` the
  stability field is computed through ``quantization.fake_quantize``
  (quantize-dequantize, straight-through update on the float shadow
  weights), so convergence means "every pattern stable at b bits".

The reference's ``TRACE_COUNTER`` counts JAX traces; nothing here is traced,
so the port has no counterpart.

**Parity with the reference.**  A row is updated when κ_i = ξ_i (W ξ)_i <
threshold in float32, and κ_i often sits on the threshold (Hebbian W holds
multiples of 1/N), so the summation order of the product can decide an
update.  The port cannot reproduce XLA's order.  Where no check of a run
lies within the float32 summation bound γ_N · Σ_j |W_ij| of the threshold
(γ_N = N·2⁻²⁴ / (1 − N·2⁻²⁴)), no order can change a decision and the
result equals the reference's exactly; elsewhere the run is *tie-bound*:
it converges as the reference does, and its own weights hold every live
pattern, but its weights may differ by a few updates of ``lr``.  The
products are float32 ``torch`` matmuls with TF32 off.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import dynamics, quantization
from repro_torch.core.checks import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static DO-I training configuration.

    ``qat_bits=0`` trains plain float DO-I; ``qat_bits=b`` measures every
    stability check on the b-bit fake-quantized weights.  ``self_coupling``
    defaults to off: the retrieval hardware stores no W_ii, and a diagonal
    term inflates every κ_i by W_ii without storing anything, so margins
    measured with self-coupling overstate what the machine retrieves.
    """

    threshold: float = 1.0
    max_sweeps: int = 500
    self_coupling: bool = False
    init_hebbian: bool = True
    qat_bits: int = 0

    def __post_init__(self) -> None:
        if self.threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {self.threshold}")
        if self.max_sweeps < 1:
            raise ValueError(f"max_sweeps must be >= 1, got {self.max_sweeps}")
        if self.qat_bits != 0 and not (2 <= self.qat_bits <= 8):
            raise ValueError(
                f"qat_bits must be 0 (off) or in [2, 8], got {self.qat_bits}"
            )


class TrainResult(NamedTuple):
    """Per-library training outputs (leading L axis iff the input had one)."""

    weights: torch.Tensor  # (..., N, N) float32 shadow weights
    sweeps: torch.Tensor  # (...,) int32: sweeps executed
    converged: torch.Tensor  # (...,) bool: every live pattern stable
    kappa_min: torch.Tensor  # (...,) float32: min margin on the *effective* weights


@contextlib.contextmanager
def _exact_float32() -> Iterator[None]:
    """TF32 off for the stability products: a TF32 product would decide
    updates on 10-bit mantissas."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _effective(cfg: TrainConfig, w: torch.Tensor, off_diag: torch.Tensor) -> torch.Tensor:
    """(L, N, N) weights the stability check sees: fake-quantized per library
    under QAT, and diagonal-masked when self-coupling is off (the check must
    not credit W_ii even if an init carries one)."""
    if cfg.qat_bits:
        w = torch.stack([quantization.fake_quantize(lib, cfg.qat_bits) for lib in w])
    if not cfg.self_coupling:
        w = w * off_diag
    return w


def _fields(w_eff: torch.Tensor, pat: torch.Tensor) -> torch.Tensor:
    """(L, N): W_eff ξ for one pattern of each library, one batched product."""
    return torch.bmm(w_eff, pat[:, :, None])[:, :, 0]


def _train(
    cfg: TrainConfig, xi: torch.Tensor, lr: torch.Tensor, count: torch.Tensor
) -> TrainResult:
    """Train L libraries: xi (L, P, N) float32, count (L,) live patterns."""
    libs, p, n = xi.shape
    dev = xi.device
    valid = (torch.arange(p, device=dev)[None, :] < count[:, None]).to(torch.float32)
    off_diag = 1.0 - torch.eye(n, dtype=torch.float32, device=dev)
    diag_mask = torch.ones((n, n), dtype=torch.float32, device=dev)
    if not cfg.self_coupling:
        diag_mask = off_diag

    if cfg.init_hebbian:
        # Sums of ±1 products are exact integers in float32, scaled by the
        # float32 reciprocal of N: the reference's ``/ n`` compiles to that.
        inv_n = torch.tensor(1.0 / n, dtype=torch.float32, device=dev)
        w = torch.bmm((xi * valid[:, :, None]).transpose(1, 2), xi) * inv_n
        if not cfg.self_coupling:
            w = w * diag_mask
    else:
        w = torch.zeros((libs, n, n), dtype=torch.float32, device=dev)

    sweeps = torch.zeros(libs, dtype=torch.int32, device=dev)
    # Sentinel 1.0: "not yet swept" (a sweep with zero updates leaves w
    # unchanged, so stopping on unstable == 0 returns the converged weights).
    unstable = torch.ones(libs, dtype=torch.float32, device=dev)
    while True:
        done = (unstable == 0) | (sweeps >= cfg.max_sweeps)
        if bool(done.all()):  # the sweep's one host read
            break
        w2 = w
        counts = torch.zeros(libs, dtype=torch.float32, device=dev)
        for j in range(p):
            pat = xi[:, j]
            # κ_i = ξ_i (W_eff ξ)_i; unstable live rows get the Hebbian
            # increment on the float shadow weights (straight-through).
            kappa = pat * _fields(_effective(cfg, w2, off_diag), pat)
            rows = (kappa < cfg.threshold).to(torch.float32) * valid[:, j, None]
            dw = lr * ((rows * pat)[:, :, None] * pat[:, None, :]) * diag_mask
            w2 = w2 + dw
            counts = counts + rows.sum(-1)
        w = torch.where(done[:, None, None], w, w2)
        sweeps = torch.where(done, sweeps, sweeps + 1)
        unstable = torch.where(done, unstable, counts)

    w_eff = _effective(cfg, w, off_diag)
    margins = torch.stack([xi[:, j] * _fields(w_eff, xi[:, j]) for j in range(p)], dim=1)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    kappa_min = torch.where(valid[:, :, None] > 0, margins, inf).amin(dim=(1, 2))
    return TrainResult(weights=w, sweeps=sweeps, converged=unstable == 0, kappa_min=kappa_min)


def train_doi(
    xi,
    config: TrainConfig = TrainConfig(),
    *,
    lr: Optional[float] = None,
    n_patterns=None,
    device=None,
) -> TrainResult:
    """Train DO-I couplings for one (P, N) library or a batch (L, P, N).

    ``lr`` defaults to 1/N of this call (rounded to float32).
    ``n_patterns`` (scalar, or (L,) when batched) masks trailing pattern
    rows — padded rows never update weights and never count as unstable.
    ``xi`` (±1, tensor or numpy) is trained on ``device``: the GPU unless
    ``"cpu"`` (the port's device rule).
    """
    dev = resolve_device(device)
    xi = torch.as_tensor(xi).to(dev, torch.float32)
    if xi.dim() not in (2, 3):
        raise ValueError(f"xi must be (P, N) or (L, P, N), got {tuple(xi.shape)}")
    p, n = xi.shape[-2], xi.shape[-1]
    step = torch.tensor((1.0 / n) if lr is None else lr, dtype=torch.float32, device=dev)
    count = torch.as_tensor(p if n_patterns is None else n_patterns).to(dev, torch.int32)
    if xi.dim() == 3:
        count = torch.broadcast_to(count, xi.shape[:1])
    elif count.dim() != 0:
        raise ValueError("n_patterns must be a scalar for a single (P, N) library")
    with _exact_float32():
        res = _train(config, xi if xi.dim() == 3 else xi[None], step, count.reshape(-1))
    if xi.dim() == 2:
        res = TrainResult(*(x[0] for x in res))
    return res


def trained_params(
    cfg: dynamics.ONNConfig, weights: torch.Tensor
) -> Tuple[dynamics.OnnParams, quantization.QuantizedWeights]:
    """Project trained float weights into an ONN's serving format.

    Quantizes to ``cfg.weight_bits`` and wraps as :class:`OnnParams` on the
    weights' device, ready for ``retrieve`` / ``install_params`` — the
    train → serve seam.
    """
    if tuple(weights.shape) != (cfg.n, cfg.n):
        raise ValueError(f"weights {tuple(weights.shape)} != ({cfg.n}, {cfg.n})")
    qw = quantization.quantize_weights(weights, cfg.weight_bits)
    return dynamics.make_params(cfg, qw.values, device=weights.device), qw
