"""The DO-I parity rule: when two trainers must agree exactly, and what they
must agree on when they cannot.

DO-I updates row i for pattern ξ when κ_i = ξ_i (W_eff ξ)_i < threshold in
float32.  κ often sits on the threshold (Hebbian W holds multiples of 1/N),
so the summation order of the product can decide an update, and no two
libraries (XLA's, torch's on the CPU, cuBLAS on the card) promise one order.

:func:`replay` retraces a run: it applies the trainer's float32 updates in
order, but decides each one on the float64 field of the float32 effective
weights, and notes every check that lies within γ_N · Σ_j |W_eff,ij| (the
float32 summation bound of any order, γ_N = N·2⁻²⁴ / (1 − N·2⁻²⁴)) plus the
float64 error of the replay itself, of the threshold.  A run without such a
check is *tie-free*: every order decides every update as the replay does,
so any trainer's weights, sweeps and convergence equal the replay's exactly.
Otherwise the run is *tie-bound*.

:func:`hold` applies the rule to two results of the same training:

* tie-free: ``weights``, ``sweeps``, ``converged`` equal (``==``), the
  quantized weights equal, and each ``kappa_min`` within the bound of the
  replay's float64 minimum margin;
* tie-bound: ``converged`` agrees and, when converged, the port's own
  ``kappa_min`` meets the threshold (its last sweep found every live
  pattern stable on its own weights, and it measures ``kappa_min`` with the
  same product; the reference measures it with another, which can fall an
  ulp short: reference fault 3 in ROADMAP.md).

Used by ``tests/test_torch_train.py`` (port against ``repro``) and
``chip_smoke.py`` (card against CPU); imports numpy and torch only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

#: Unit roundoff of float32 and float64.
U32, U64 = 2.0**-24, 2.0**-53


def gamma(n: int, u: float) -> float:
    """γ_n = n·u / (1 − n·u), the relative bound of an n-term summation."""
    return n * u / (1.0 - n * u)


@dataclasses.dataclass(eq=False)
class Replay:
    weights: np.ndarray  # (N, N) float32: the replayed trajectory's weights
    sweeps: int
    converged: bool
    kappa_min: float  # float64 minimum margin on the final effective weights
    kappa_bound: float  # what a float32 kappa_min may differ from it by
    ties: List[Tuple[int, int, int, float, float]]  # (sweep, pattern, row, κ64, bound)

    @property
    def tie_free(self) -> bool:
        return not self.ties


def replay(
    xi,
    *,
    threshold: float = 1.0,
    lr: Optional[float] = None,
    max_sweeps: int = 500,
    self_coupling: bool = False,
    init_hebbian: bool = True,
    qat_bits: int = 0,
    n_patterns: Optional[int] = None,
    fake_quantize: Optional[Callable] = None,
) -> Replay:
    """Retrace one (P, N) library's DO-I run (the defaults are
    ``TrainConfig()``'s).  ``fake_quantize(w_float32_tensor, bits)`` gives
    the QAT effective weights; it must be bit-equal to the trainers'."""
    x = np.asarray(xi, np.float32)
    p, n = x.shape
    count = p if n_patterns is None else int(n_patterns)
    valid = (np.arange(p) < count).astype(np.float32)
    lr32 = np.float32((1.0 / n) if lr is None else lr)
    thr = float(np.float32(threshold))
    off_diag = (1.0 - np.eye(n)).astype(np.float32)
    mask = np.ones((n, n), np.float32) if self_coupling else off_diag
    g = gamma(n, U32) + gamma(n, U64)

    def effective(w: np.ndarray) -> np.ndarray:
        if qat_bits:
            w = fake_quantize(torch.from_numpy(w), qat_bits).numpy()
        return w if self_coupling else w * off_diag

    if init_hebbian:
        w = ((x * valid[:, None]).T @ x) * np.float32(1.0 / n)  # XLA's form of / n
        w = w.astype(np.float32) * (off_diag if not self_coupling else np.float32(1.0))
    else:
        w = np.zeros((n, n), np.float32)

    ties: List[Tuple[int, int, int, float, float]] = []
    sweeps, unstable = 0, 1.0
    while unstable != 0 and sweeps < max_sweeps:
        counts = 0.0
        for j in range(p):
            eff = effective(w).astype(np.float64)
            kappa = x[j] * (eff @ x[j].astype(np.float64))
            if valid[j]:
                bound = g * np.abs(eff).sum(axis=1)
                for i in np.flatnonzero(np.abs(kappa - thr) <= bound):
                    ties.append((sweeps, j, int(i), float(kappa[i]), float(bound[i])))
            rows = ((kappa < thr) & (valid[j] > 0)).astype(np.float32)
            dw = (lr32 * np.outer(rows * x[j], x[j]).astype(np.float32)) * mask
            w = (w + dw).astype(np.float32)
            counts += float(rows.sum())
        sweeps += 1
        unstable = counts
    eff = effective(w).astype(np.float64)
    live = x[:count].astype(np.float64)
    margins = live * (live @ eff.T)
    kappa_min = float(margins.min()) if count else float("inf")
    return Replay(
        weights=w, sweeps=sweeps, converged=unstable == 0, kappa_min=kappa_min,
        kappa_bound=float((g * np.abs(eff).sum(axis=1)).max()), ties=ties,
    )


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def hold(got, want, rp: Replay, threshold: float = 1.0, quantize=None, what: str = "",
         ports: Tuple[str, ...] = ("got",)) -> str:
    """Hold two results of one training (``weights``, ``sweeps``,
    ``converged``, ``kappa_min`` fields) to each other under the DO-I rule;
    ``quantize(weights) -> int8 values`` checks the serving weights too, and
    ``ports`` names the results that are the port's.  Returns
    ``"tie_free"`` or ``"tie_bound"``; raises AssertionError."""

    def check(ok: bool, msg: str) -> None:
        if not ok:
            raise AssertionError(f"DO-I rule{' ' + what if what else ''}: {msg}")

    conv_g, conv_w = bool(_numpy(got.converged)), bool(_numpy(want.converged))
    check(conv_g == conv_w, f"converged {conv_g} != {conv_w}")
    if rp.tie_free:
        wg, ww = _numpy(got.weights), _numpy(want.weights)
        check(np.array_equal(wg, ww), f"weights differ (max |dW| {np.abs(wg - ww).max()})")
        check(int(_numpy(got.sweeps)) == int(_numpy(want.sweeps)), "sweeps differ")
        check(conv_g == rp.converged and np.array_equal(wg, rp.weights),
              "the replay of a tie-free run disagrees")
        if quantize is not None:
            check(np.array_equal(_numpy(quantize(got.weights)), _numpy(quantize(want.weights))),
                  "quantized weights differ")
        for label, res in (("got", got), ("want", want)):
            k = float(_numpy(res.kappa_min))
            check(abs(k - rp.kappa_min) <= rp.kappa_bound or k == rp.kappa_min,
                  f"{label} kappa_min {k} off the replay's {rp.kappa_min} by more than "
                  f"{rp.kappa_bound}")
        return "tie_free"
    if conv_g:
        thr = float(np.float32(threshold))
        for label, res in (("got", got), ("want", want)):
            if label not in ports:
                continue
            k = float(_numpy(res.kappa_min))
            check(k >= thr, f"{label} converged but its kappa_min {k} < {thr}")
    return "tie_bound"
