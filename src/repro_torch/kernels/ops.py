"""Public wrappers around the port's kernels.

Each wrapper keeps the padding and dtype contract of its counterpart in
``repro.kernels.ops``.  The route is chosen by where the tensors lie:

* on the CPU, the plain PyTorch version in :mod:`repro_torch.kernels.ref`;
* on a CUDA device, the hand-written kernel in ``csrc/`` (built at first use
  by :mod:`repro_torch.kernels.build`), launched on PyTorch's current stream.
  A build or launch failure raises; there is no fallback.

Every launch adds one to :data:`LAUNCHES` under the kernel's name, so a run
can show which kernels its path went through.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from repro_torch.core.checks import require_int_dtype
from repro_torch.core.quantization import pack_phases, unpack_phases
from repro_torch.kernels import autotune, build
from repro_torch.kernels import ref as _ref

#: Kernel launches by name; incremented once per launch, nowhere else.
LAUNCHES: collections.Counter = collections.Counter()

#: Launch-count keys: one per kernel; the multi-cycle kernel's packed
#: instantiation counts apart from the unpacked one.
KERNELS = (
    "coupling_sum", "phase_step", "phase_step_packed", "phase_step_multi",
    "phase_step_multi_packed",
)


def reset_launches() -> None:
    """Set every launch count to 0."""
    LAUNCHES.clear()


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True if the operands lie on one CUDA device, False if all on the CPU."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel operands on different devices: {sorted(map(str, devices))}")
    return devices.pop().type == "cuda"


def _launch(stem: str, name: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``'s current stream; raise on error."""
    fn = getattr(build.library(stem), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream  # repro-lint: disable=RPL008
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _check_extent(*sizes: int) -> None:
    for s in sizes:
        if s >= 2**31:
            raise ValueError(f"kernel extent {s} does not fit a 32-bit index")


def _bias(bias, n: int, like: torch.Tensor) -> torch.Tensor:
    if bias is None:
        return torch.zeros((n,), dtype=torch.int32, device=like.device)
    return require_int_dtype(bias, "bias").to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel 1: S = σ Wᵀ
# ---------------------------------------------------------------------------


def coupling_sum(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """S = W σ for spins of shape (N,) or (..., N); returns int32 (..., M).

    ``w`` is (M, N): the full coupling matrix, or a row slab with M < N.
    """
    require_int_dtype(w, "w")
    m, n = w.shape
    batch_shape = sigma.shape[:-1]
    sig2d = sigma.reshape(-1, n).to(torch.int8)
    if not _on_cuda(w, sig2d):
        out = _ref.coupling_sum_ref(w, sig2d)
    else:
        b = sig2d.shape[0]
        _check_extent(b * n, m * n, b * m)
        w8 = w.to(torch.int8).contiguous()
        sig2d = sig2d.contiguous()
        out = torch.empty((b, m), dtype=torch.int32, device=sig2d.device)
        _launch(
            "coupling_gemm", "onn_coupling_sum", sig2d.device,
            sig2d.data_ptr(), w8.data_ptr(), out.data_ptr(), b, m, n,
        )
        LAUNCHES["coupling_sum"] += 1
    return out.reshape(*batch_shape, m)


# ---------------------------------------------------------------------------
# Kernel 3: θ' = phase-align(W σ + h, θ)
# ---------------------------------------------------------------------------


def phase_step(
    w: torch.Tensor,
    sigma: torch.Tensor,
    bias,
    phase: torch.Tensor,
    *,
    half: int,
) -> torch.Tensor:
    """Fused functional-mode cycle; ``sigma``/``phase`` (N,) or (..., N).

    ``phase`` is returned in its input dtype.  One launch per cycle.
    """
    require_int_dtype(w, "w")
    n = w.shape[0]
    batch_shape = sigma.shape[:-1]
    sig2d = sigma.reshape(-1, n).to(torch.int8)
    ph2d = phase.reshape(-1, n).to(torch.int32)
    h = _bias(bias, n, w)
    if not _on_cuda(w, sig2d, ph2d, h):
        out = _ref.phase_step_ref(w, sig2d, h, ph2d, half)
    else:
        b = sig2d.shape[0]
        _check_extent(b * n, n * n)
        w8, sig2d, ph2d, h = (x.contiguous() for x in (w.to(torch.int8), sig2d, ph2d, h))
        out = torch.empty((b, n), dtype=torch.int32, device=sig2d.device)
        _launch(
            "coupling_gemm", "onn_phase_step", sig2d.device,
            sig2d.data_ptr(), w8.data_ptr(), h.data_ptr(), ph2d.data_ptr(),
            out.data_ptr(), b, n, half,
        )
        LAUNCHES["phase_step"] += 1
    return out.to(phase.dtype).reshape(*batch_shape, n)


# ---------------------------------------------------------------------------
# Kernel 4: the same cycle with a packed 4-bit phase operand
# ---------------------------------------------------------------------------


def phase_step_packed(
    w: torch.Tensor,
    bias,
    phase: torch.Tensor,
    *,
    half: int,
) -> torch.Tensor:
    """Packed-operand cycle: θ' = phase-align(W σ(θ) + h, θ).

    Takes *unpacked* (..., N) counters and no σ operand; on the card they
    cross the kernel boundary two per byte (low nibble first, an odd N pads a
    zero nibble) and σ = +1 iff θ < half is derived in registers.  W must be
    square.  Bit-exact with :func:`phase_step` fed ``spin(phase)``.
    """
    require_int_dtype(w, "w")
    n = w.shape[0]
    if w.shape[1] != n:
        raise ValueError(f"phase_step_packed: weights {tuple(w.shape)} not square")
    batch_shape = phase.shape[:-1]
    ph2d = phase.reshape(-1, n)
    h = _bias(bias, n, w)
    if not _on_cuda(w, ph2d, h):
        out = _ref.phase_step_packed_ref(w, h, ph2d, half)
    else:
        b = ph2d.shape[0]
        _check_extent(b * n, n * n)
        packed = pack_phases(ph2d).contiguous()
        w8, h = w.to(torch.int8).contiguous(), h.contiguous()
        out = torch.empty((b, n), dtype=torch.int32, device=ph2d.device)
        _launch(
            "coupling_gemm", "onn_phase_step_packed", ph2d.device,
            packed.data_ptr(), w8.data_ptr(), h.data_ptr(), out.data_ptr(), b, n, half,
        )
        LAUNCHES["phase_step_packed"] += 1
    return out.to(phase.dtype).reshape(*batch_shape, n)


# ---------------------------------------------------------------------------
# Kernel 5: `chunk` cycles + settle/freeze bookkeeping in one launch
# ---------------------------------------------------------------------------


def phase_step_multi(
    w: torch.Tensor,
    bias,
    phase: torch.Tensor,
    prev_phase: torch.Tensor,
    t: torch.Tensor,
    settle_cycle: torch.Tensor,
    settled: torch.Tensor,
    cycled: torch.Tensor,
    frozen: torch.Tensor,
    frozen_p2: torch.Tensor,
    freeze_cycle: torch.Tensor,
    *,
    half: int,
    chunk: int,
    max_cycles: int,
    packed: bool = False,
):
    """Run ``chunk`` functional-mode cycles + bookkeeping in one launch.

    ``phase``/``prev_phase``: (B, N) counters (any integer dtype);
    ``t``/``settle_cycle``/``freeze_cycle``: (B,) int32;
    ``settled``/``cycled``/``frozen``/``frozen_p2``: (B,) bool.  Returns the
    9-tuple (phase, prev_phase, settle_cycle, settled, cycled, frozen,
    frozen_p2, freeze_cycle, t) in the input dtypes.  ``packed`` moves the
    phase state through the kernel boundary two 4-bit counters per byte.
    """
    require_int_dtype(w, "w")
    if chunk < 1:
        raise ValueError(f"phase_step_multi: chunk must be >= 1, got {chunk}")
    b, n = phase.shape
    if w.shape != (n, n):
        raise ValueError(f"phase_step_multi: weights {tuple(w.shape)} != ({n}, {n})")
    h = _bias(bias, n, w)
    cols = (t, settle_cycle, settled, cycled, frozen, frozen_p2, freeze_cycle)
    if not _on_cuda(w, h, phase, prev_phase, *cols):
        outs = _ref.phase_step_multi_ref(
            w, h, phase, prev_phase, *(c.to(torch.int32)[:, None] for c in cols),
            half=half, chunk=chunk, max_cycles=max_cycles,
        )
        ph_o, prev_o = outs[0], outs[1]
        sc_o, sd_o, cy_o, fz_o, fp2_o, fc_o, t_o = (o[:, 0] for o in outs[2:])
    else:
        _check_extent(b * n, n * autotune.padded_k(n))
        kp = autotune.padded_k(n)
        w_p = F.pad(w.to(torch.int8), (0, kp - n)).contiguous()
        h = h.contiguous()
        cols_in = torch.stack([c.to(torch.int32) for c in cols]).contiguous()
        if packed:
            ph_in, prev_in = pack_phases(phase).contiguous(), pack_phases(prev_phase).contiguous()
        else:
            ph_in = phase.to(torch.int32).contiguous()
            prev_in = prev_phase.to(torch.int32).contiguous()
        ph_out, prev_out = torch.empty_like(ph_in), torch.empty_like(prev_in)
        cols_out = torch.empty_like(cols_in)
        _launch(
            "phase_step_multi", "onn_phase_step_multi", phase.device,
            w_p.data_ptr(), h.data_ptr(), ph_in.data_ptr(),
            prev_in.data_ptr(), cols_in.data_ptr(), ph_out.data_ptr(),
            prev_out.data_ptr(), cols_out.data_ptr(), b, n, kp, half, chunk,
            max_cycles, int(packed), autotune.multi_lanes_per_block(n, b),
        )
        LAUNCHES["phase_step_multi_packed" if packed else "phase_step_multi"] += 1
        if packed:
            ph_out, prev_out = unpack_phases(ph_out, n), unpack_phases(prev_out, n)
        ph_o, prev_o = ph_out, prev_out
        t_o, sc_o, sd_o, cy_o, fz_o, fp2_o, fc_o = cols_out.unbind(0)

    def like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        return x != 0 if ref.dtype == torch.bool else x.to(ref.dtype)

    return (
        ph_o.to(phase.dtype),
        prev_o.to(prev_phase.dtype),
        like(sc_o, settle_cycle),
        like(sd_o, settled),
        like(cy_o, cycled),
        like(fz_o, frozen),
        like(fp2_o, frozen_p2),
        like(fc_o, freeze_cycle),
        like(t_o, t),
    )
