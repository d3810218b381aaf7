"""Public wrappers around the port's kernels.

Each wrapper keeps the padding and dtype contract of its counterpart in
``repro.kernels.ops``.  The route is chosen by where the tensors lie:

* on the CPU, the plain PyTorch version in :mod:`repro_torch.kernels.ref`;
* on a CUDA device, the hand-written kernel in ``csrc/`` (built at first use
  by :mod:`repro_torch.kernels.build`), launched on PyTorch's current stream.
  A build or launch failure raises; there is no fallback.

Every launch adds one to :data:`LAUNCHES` under the kernel's name, so a run
can show which kernels its path went through; a launch of the coupling GEMM
also adds one to :data:`REGIME_LAUNCHES` under its regime.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.checks import require_int_dtype
from repro_torch.core.quantization import pack_phases, unpack_phases
from repro_torch.kernels import autotune, build
from repro_torch.kernels import ref as _ref

#: Kernel launches by name; incremented once per launch, nowhere else.
LAUNCHES: collections.Counter = collections.Counter()

#: Launch-count keys: one per kernel; the multi-cycle kernel's packed
#: instantiation counts apart from the unpacked one, and the coupling sums'
#: launches over an instance axis (a 3-d W) apart from the 2-d ones.
KERNELS = (
    "coupling_sum", "onn_step", "phase_step", "phase_step_packed", "phase_step_multi",
    "phase_step_multi_packed", "hybrid_coupling_sum", "hybrid_phase_step",
    "quantized_matvec", "coupling_sum_batched", "hybrid_coupling_sum_batched",
)


#: Launches of the coupling GEMM (kernels 1-4, 6, 7) by regime, keyed
#: ``"<kernel>/<regime>"``: a tile of ``csrc/coupling_gemm.cu`` (``wide``,
#: ``split``) or ``wgmma`` (``csrc/coupling_wgmma.cu``); each also counts in
#: :data:`LAUNCHES` under its kernel.
REGIME_LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    """Set every launch count to 0."""
    LAUNCHES.clear()
    REGIME_LAUNCHES.clear()


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


def _at(t: torch.Tensor, elems: int) -> int:
    """The address of ``t``'s element ``elems`` (a contiguous tensor)."""
    return t.data_ptr() + elems * t.element_size()


def _gemm(name: str, entry: str, plan: autotune.CouplingPlan, device: torch.device, args) -> None:
    """Every launch of ``plan`` (:attr:`~autotune.CouplingPlan.launches`)
    through the coupling GEMM's ``entry``, in order on one stream, one count
    each: ``args(i0, ni, b0, nb)`` gives one launch's arguments, the
    operands offset to its first instance and lane."""
    for i0, ni, b0, nb in plan.launches:
        _launch("coupling_gemm", entry, device, *args(i0, ni, b0, nb), *plan.args)
        LAUNCHES[name] += 1
        REGIME_LAUNCHES[f"{name}/{plan.regime}"] += 1


def _tma_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (rows, n) int8, contiguous, as TMA reads it: itself where its
    base and row pitch are 16-byte aligned, else a copy zero-padded into
    fresh rows of ``autotune.tma_pitch(n)`` bytes (N = 506: 512), on the
    card by ``coupling_wgmma.cu``'s row copy (not counted as a launch: it is
    the wgmma regime's operand preparation)."""
    if x.data_ptr() % autotune.TMA_ALIGN == 0 and n % autotune.TMA_ALIGN == 0:
        return x
    rows, pitch = x.shape[0], autotune.tma_pitch(n)
    if x.device.type != "cuda":
        out = torch.zeros((rows, pitch), dtype=torch.int8, device=x.device)
        out[:, :n] = x
        return out
    out = torch.empty((rows, pitch), dtype=torch.int8, device=x.device)
    _launch("coupling_wgmma", "onn_tma_rows", x.device, x.data_ptr(), rows, n, out.data_ptr(),
            pitch)
    return out


def _wgmma(name: str, plan: autotune.WgmmaPlan, sigma: torch.Tensor, w8: torch.Tensor,
           bias, out: torch.Tensor) -> None:
    """Kernel 1 or 2 (``name``) in the wgmma regime: one launch of ``plan``
    on σ (B, N) and W (M, N), int8 and contiguous, into ``out`` (B, M),
    zeroed by the caller when the plan splits K."""
    n = plan.n
    s_t, w_t = _tma_rows(sigma, n), _tma_rows(w8, n)
    _launch("coupling_wgmma", "onn_coupling_wgmma", sigma.device, GEMM_MODES[name],
            s_t.data_ptr(), s_t.stride(0), w_t.data_ptr(), w_t.stride(0),
            None if bias is None else bias.data_ptr(), out.data_ptr(), plan.b, plan.m, n,
            *plan.args)
    LAUNCHES[name] += 1
    REGIME_LAUNCHES[f"{name}/wgmma"] += 1


def _bias(bias, n: int, like: torch.Tensor) -> torch.Tensor:
    if bias is None:
        return torch.zeros((n,), dtype=torch.int32, device=like.device)
    return require_int_dtype(bias, "bias").to(torch.int32)


# ---------------------------------------------------------------------------
# Kernels 1 and 6: S = σ Wᵀ, for one W or one W per instance
# ---------------------------------------------------------------------------


def _coupling_sums(name: str, w: torch.Tensor, sigma: torch.Tensor, parallel) -> torch.Tensor:
    """Kernel 1 (``parallel`` None) or kernel 6, on a 2-d or 3-d ``w``.

    A 2-d call is the kernel's I = 1 case; a 3-d ``w`` (I, M, N) takes
    ``sigma`` (I, ..., N), one launch for every instance (a plan past CUDA's
    grid limits cuts it into several, :func:`_gemm`), counted under
    ``<name>_batched``.
    """
    require_int_dtype(w, "w")
    batched = w.dim() == 3
    if w.dim() not in (2, 3):
        raise ValueError(f"{name}: weights must be (M, N) or (I, M, N), got {tuple(w.shape)}")
    m, n = w.shape[-2:]
    inst = w.shape[0] if batched else 1
    if sigma.shape[-1] != n or (batched and (sigma.dim() < 2 or sigma.shape[0] != inst)):
        raise ValueError(f"{name}: spins {tuple(sigma.shape)} do not fit weights {tuple(w.shape)}")
    lead = sigma.shape[:-1]
    sig3 = sigma.reshape(inst, -1, n).to(torch.int8)
    w3 = w if batched else w[None]
    if not _on_cuda(w3, sig3):
        out = (_ref.coupling_sum_ref(w3, sig3) if parallel is None
               else _ref.hybrid_coupling_sum_ref(w3, sig3, parallel))
    else:
        b = sig3.shape[1]
        _check_extent(inst, b, m, n)
        w8, sig3 = w3.to(torch.int8).contiguous(), sig3.contiguous()
        plan = autotune.coupling_route(name, inst, b, m, n, parallel)
        if isinstance(plan, autotune.WgmmaPlan):  # kernel 1 at a large shape
            out = (torch.zeros if plan.splits > 1 else torch.empty)(
                (inst, b, m), dtype=torch.int32, device=sig3.device)
            _wgmma(name, plan, sig3[0], w8[0], None, out)
        else:
            out = torch.empty((inst, b, m), dtype=torch.int32, device=sig3.device)
            _gemm(f"{name}_batched" if batched else name, "onn_coupling_sum", plan, sig3.device,
                  lambda i0, ni, b0, nb: (_at(sig3, (i0 * b + b0) * n), _at(w8, i0 * m * n),
                                          _at(out, (i0 * b + b0) * m), ni, nb, m, n))
    return out.reshape(*lead, m)


def coupling_sum(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """S = W σ for spins of shape (N,) or (..., N); returns int32 (..., M).

    ``w`` is (M, N): the full coupling matrix, or a row slab with M < N; or
    (I, M, N), one such matrix per instance, with spins (I, ..., N) →
    (I, ..., M) in one launch.
    """
    return _coupling_sums("coupling_sum", w, sigma, None)


# ---------------------------------------------------------------------------
# Kernel 2: σ' = sign(W σ + h), ties keep σ
# ---------------------------------------------------------------------------


def onn_step(w: torch.Tensor, sigma: torch.Tensor, bias=None) -> torch.Tensor:
    """One fused ONN spin update: σ' = sign(W σ + h) as int8, where
    W σ + h == 0 keeps σ.  ``w`` (N, N); ``sigma`` (N,) or (..., N); ``bias``
    (N,) integers or None (zeros).  One launch per call (several past
    65,535 lane tiles: ``autotune.CouplingPlan.launches``; one in the wgmma
    regime, ``autotune.coupling_route``).
    """
    require_int_dtype(w, "w")
    n = w.shape[0]
    if tuple(w.shape) != (n, n):
        raise ValueError(f"onn_step: weights {tuple(w.shape)} not square")
    batch_shape = sigma.shape[:-1]
    sig2d = sigma.reshape(-1, n).to(torch.int8)
    h = _bias(bias, n, w)
    if not _on_cuda(w, sig2d, h):
        out = _ref.onn_step_ref(w, sig2d, h)
    else:
        b = sig2d.shape[0]
        _check_extent(b, n)
        w8, sig2d, h = (x.contiguous() for x in (w.to(torch.int8), sig2d, h))
        out = torch.empty((b, n), dtype=torch.int8, device=sig2d.device)
        plan = autotune.coupling_route("onn_step", 1, b, n, n)
        if isinstance(plan, autotune.WgmmaPlan):
            _wgmma("onn_step", plan, sig2d, w8, h, out)
        else:
            _gemm("onn_step", "onn_step", plan, sig2d.device,
                  lambda _i0, _ni, b0, nb: (_at(sig2d, b0 * n), w8.data_ptr(), h.data_ptr(),
                                            _at(out, b0 * n), nb, n))
    return out.reshape(*batch_shape, n)


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

    ``phase`` is returned in its input dtype.  One launch per cycle (several
    past 65,535 lane tiles).
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
        _check_extent(b, n)
        w8, sig2d, ph2d, h = (x.contiguous() for x in (w.to(torch.int8), sig2d, ph2d, h))
        out = torch.empty((b, n), dtype=torch.int32, device=sig2d.device)
        _phase_gemm("phase_step", autotune.coupling_plan(1, b, n, n), w8, sig2d, h, ph2d, out,
                    half)
    return out.to(phase.dtype).reshape(*batch_shape, n)


def _phase_gemm(name: str, plan: autotune.CouplingPlan, w8, sig2d, h, ph2d, out, half: int):
    """Kernel 3's entry (kernel 7 on the walk of its MAC width) over ``plan``'s launches."""
    n = w8.shape[0]
    _gemm(name, "onn_phase_step", plan, sig2d.device,
          lambda _i0, _ni, b0, nb: (_at(sig2d, b0 * n), w8.data_ptr(), h.data_ptr(),
                                    _at(ph2d, b0 * n), _at(out, b0 * n), nb, n, half))


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
        _check_extent(b, n)
        packed = pack_phases(ph2d).contiguous()
        w8, h = w.to(torch.int8).contiguous(), h.contiguous()
        out = torch.empty((b, n), dtype=torch.int32, device=ph2d.device)
        pw = packed.shape[-1]
        _gemm("phase_step_packed", "onn_phase_step_packed", autotune.coupling_plan(1, b, n, n),
              ph2d.device,
              lambda _i0, _ni, b0, nb: (_at(packed, b0 * pw), w8.data_ptr(), h.data_ptr(),
                                        _at(out, b0 * n), nb, n, half))
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
    On the card the launch follows :func:`~repro_torch.kernels.autotune.multi_plan`
    (W held in a thread-block cluster's shared memory up to
    ``MULTI_CLUSTER_MAX_N``, streamed from L2 past it); a refused launch
    raises.
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
        plan = autotune.multi_plan(b, n)
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
            max_cycles, int(packed), *plan.args,
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


def multi_cluster_occupancy(plan: autotune.MultiPlan, packed: bool = False) -> int:
    """How many clusters of a cluster-regime plan of kernel 5 the current
    card holds at once (``cudaOccupancyMaxActiveClusters``); 0: it cannot
    launch there.  Counts no launch."""
    if plan.regime != "cluster":
        raise ValueError(f"multi_cluster_occupancy: {plan.regime} plan has no cluster")
    out = ctypes.c_int(0)
    fn = build.library("phase_step_multi").onn_phase_step_multi_occupancy
    rc = fn(int(packed), plan.cluster, plan.lanes, plan.rows, plan.smem_bytes,
            ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"onn_phase_step_multi_occupancy: CUDA error {rc}")
    return out.value


#: What the sources' attribute entries read of one compiled instantiation, in
#: the order of their out array (``csrc/attributes.cuh``):
#: ``cudaFuncGetAttributes``' ``numRegs``, ``localSizeBytes``,
#: ``sharedSizeBytes`` and ``maxThreadsPerBlock``, then
#: ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the launch's threads
#: and dynamic shared memory (after its opt-in), then those threads.
ATTRIBUTES = ("registers", "local_bytes", "static_smem", "max_threads", "blocks_per_sm",
              "threads")

#: The coupling GEMM's modes (``csrc/coupling_gemm.cu`` ``Mode``), by the entry
#: that launches each; kernels 6 and 7 run kernel 1's and kernel 3's.
GEMM_MODES = {"coupling_sum": 0, "phase_step": 1, "phase_step_packed": 2, "onn_step": 3}


def _attributes(stem: str, name: str, *args: int) -> dict:
    out = (ctypes.c_int * len(ATTRIBUTES))()
    rc = getattr(build.library(stem), name)(*args, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    return dict(zip(ATTRIBUTES, out))


def coupling_attributes(plan: autotune.CouplingPlan, mode: str) -> dict:
    """The compiled instantiation of the coupling GEMM that a launch of
    ``plan`` by the entry ``mode`` (a key of :data:`GEMM_MODES`) runs on the
    current card: :data:`ATTRIBUTES`.  Counts no launch."""
    return _attributes("coupling_gemm", "onn_coupling_gemm_attributes", GEMM_MODES[mode],
                       *plan.args)


def wgmma_attributes(plan: autotune.WgmmaPlan, mode: str) -> dict:
    """The compiled instantiation of the wgmma regime that a launch of
    ``plan`` by the entry ``mode`` (``"coupling_sum"`` or ``"onn_step"``)
    runs on the current card: :data:`ATTRIBUTES`.  Counts no launch."""
    return _attributes("coupling_wgmma", "onn_coupling_wgmma_attributes", GEMM_MODES[mode],
                       *plan.args[:3])


def multi_attributes(plan: autotune.MultiPlan, packed: bool = False) -> dict:
    """The compiled instantiation of kernel 5 that a launch of ``plan`` runs
    on the current card: :data:`ATTRIBUTES`.  Counts no launch."""
    return _attributes("phase_step_multi", "onn_phase_step_multi_attributes", plan.n,
                       autotune.padded_k(plan.n), int(packed), *plan.args)


def qmv_attributes(plan: autotune.QmvPlan) -> dict:
    """The compiled instantiation of kernel 8 that a launch of ``plan`` runs
    on the current card: :data:`ATTRIBUTES`.  Counts no launch."""
    return _attributes("quantized_matvec", "onn_quantized_matvec_attributes", plan.lanes,
                       plan.k_chunk, int(plan.vector))


# ---------------------------------------------------------------------------
# Kernels 6 and 7: the hybrid serialized-MAC coupling sum, and its phase step
# ---------------------------------------------------------------------------


def _check_parallel(parallel: int) -> None:
    if parallel <= 0:
        raise ValueError(f"parallel must be positive, got {parallel}")
    _check_extent(parallel)


def hybrid_coupling_sum(w: torch.Tensor, sigma: torch.Tensor, *, parallel: int) -> torch.Tensor:
    """S = W σ as ``ceil(N / parallel)`` passes of a ``parallel``-wide MAC.

    Same shapes as :func:`coupling_sum`: spins (N,) or (..., N) against an
    (M, N) matrix or row slab, or spins (I, ..., N) against one (M, N)
    matrix per instance.  Bit-exact with :func:`coupling_sum` for every P;
    one launch per call, walking the contraction one group of whole passes
    at a time.
    """
    _check_parallel(parallel)
    return _coupling_sums("hybrid_coupling_sum", w, sigma, parallel)


def hybrid_phase_step(
    w: torch.Tensor,
    sigma: torch.Tensor,
    bias,
    phase: torch.Tensor,
    *,
    half: int,
    parallel: int,
) -> torch.Tensor:
    """Fused hybrid functional-mode cycle: θ' = phase-align(W σ + h, θ) with
    the coupling sum serialized into passes of MAC width ``parallel``.

    Same calling convention as :func:`phase_step` (W square, ``phase``
    returned in its input dtype).  One launch per cycle (several past 65,535
    lane tiles).
    """
    require_int_dtype(w, "w")
    _check_parallel(parallel)
    n = w.shape[0]
    batch_shape = sigma.shape[:-1]
    sig2d = sigma.reshape(-1, n).to(torch.int8)
    ph2d = phase.reshape(-1, n).to(torch.int32)
    h = _bias(bias, n, w)
    if not _on_cuda(w, sig2d, ph2d, h):
        out = _ref.hybrid_phase_step_ref(w, sig2d, h, ph2d, half, parallel)
    else:
        b = sig2d.shape[0]
        _check_extent(b, n)
        w8, sig2d, ph2d, h = (x.contiguous() for x in (w.to(torch.int8), sig2d, ph2d, h))
        out = torch.empty((b, n), dtype=torch.int32, device=sig2d.device)
        # Kernel 7 is kernel 3's entry point on the walk of MAC width P.
        _phase_gemm("hybrid_phase_step", autotune.coupling_plan(1, b, n, n, parallel), w8,
                    sig2d, h, ph2d, out, half)
    return out.to(phase.dtype).reshape(*batch_shape, n)


# ---------------------------------------------------------------------------
# Kernel 8: y = (x W_qᵀ) · scale, float32 activations × int8 weights
# ---------------------------------------------------------------------------


def quantized_matvec(w_q: torch.Tensor, scale, x: torch.Tensor) -> torch.Tensor:
    """y = (W_q · scale) x in float32 with a per-row (M,) or scalar scale.

    ``w_q`` (M, K) int8; ``x`` (K,) or (..., K), cast to float32 → (..., M)
    float32.  Each element is within K · 2⁻²⁴ · |scale_m| · Σ_k |x_k w_mk|
    of the exact value (float32 summation, in the kernel's order on the
    card and the matmul's on the CPU).  One launch per call (one per run of
    65,535 lane tiles past that), planned by
    :func:`~repro_torch.kernels.autotune.qmv_plan`; when it splits K, the
    wrapper also allocates the partial sums and the zeroed arrival counters,
    and the kernel sums the partials in a fixed order, so two calls on the
    same inputs give the same bits.
    """
    require_int_dtype(w_q, "w_q")
    m, k = w_q.shape
    if x.shape[-1] != k:
        raise ValueError(f"quantized_matvec: x {tuple(x.shape)} does not fit weights {tuple(w_q.shape)}")
    batch_shape = x.shape[:-1]
    x2d = x.reshape(-1, k).to(torch.float32)
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(scale, dtype=torch.float32, device=w_q.device)
    scale_full = torch.broadcast_to(scale.to(torch.float32), (m,))
    if not _on_cuda(w_q, x2d, scale_full):
        out = _ref.quantized_matvec_ref(w_q, scale_full, x2d)
    else:
        b = x2d.shape[0]
        _check_extent(b, m, k)
        w8, x2d, s = (t.contiguous() for t in (w_q.to(torch.int8), x2d, scale_full))
        aligned = x2d.data_ptr() % 16 == 0 and w8.data_ptr() % 16 == 0
        plan = autotune.qmv_plan(b, m, k, aligned=aligned)
        out = torch.empty((b, m), dtype=torch.float32, device=x2d.device)
        partial = counters = None
        if plan.splits > 1:
            partial = torch.empty((plan.workspace,), dtype=torch.float32, device=x2d.device)
            counters = torch.zeros((plan.counters,), dtype=torch.int32, device=x2d.device)
        # Past 65,535 GEMM lane tiles, runs of lanes in order on one stream;
        # each leaves the counters zero for the next.  A run's first lane is
        # a multiple of 128 × 65,535, so x's offset keeps the vector path's
        # 16-byte alignment.
        for b0, nb in plan.launches:
            _launch(
                "quantized_matvec", "onn_quantized_matvec", x2d.device,
                _at(x2d, b0 * k), w8.data_ptr(), s.data_ptr(), _at(out, b0 * m),
                None if partial is None else partial.data_ptr(),
                None if counters is None else counters.data_ptr(),
                nb, m, k, plan.lanes, plan.k_chunk, plan.splits, int(plan.vector),
            )
            LAUNCHES["quantized_matvec"] += 1
    return out.reshape(*batch_shape, m)
