"""ONN dynamics on PyTorch tensors: the port of ``repro.core.dynamics``.

Entry points are plain functions of

* ``ONNConfig`` — sizes, bit widths, mode and backend (every field and
  validation rule of the reference; the kernel route is ``"kernel"``);
* ``OnnParams`` — the (N, N) int8 coupling matrix and (N,) int32 bias;
* ``OnnState`` / ``BatchState`` — the dynamical state, as ``NamedTuple`` s.

Simulation fidelities (``ONNConfig.mode``):

* ``functional`` — one synchronous phase update per oscillation cycle,
  σ(t+1) = sign-align(W σ(t) + h), the paper's associative-memory workload.
* ``rtl`` — clock-accurate: the phase is updated every slow-clock edge
  (2**phase_bits per cycle) against amplitudes in the lab frame, and the
  hybrid architecture consumes amplitudes one slow clock late (paper
  Fig. 6).  With ``sync_jitter`` each lane's enable-signal offset ``t0`` is
  an explicit int input (``run``) or (B,) int32 tensor (``run_batch``,
  ``retrieve``, ``init_batch_state``); the port draws no random numbers.

Weighted-sum backends: ``parallel`` and ``serial`` (exact float products,
``core.coupling``), ``kernel`` (the hand-written coupling kernels) and
``hybrid`` — the paper's serialized-MAC datapath, ``ceil(N / P)`` passes of
a P-wide MAC, through :func:`hybrid_mac_sum` (``hybrid_impl="scan"``) or
kernels 6 and 7 (``hybrid_impl="kernel"``).  All are bit-exact.

Every function runs on the device of its inputs.  The batched solve
(``run_batch`` / ``retrieve``) advances a (B, N) slab one settle-chunk at a
time and exits early once every lane is frozen (settled or in a detected
period-2 orbit), with one host synchronisation per chunk; results are
bit-exact, lane for lane, with the fixed-length ``run``.  In functional mode
a chunk on ``backend="kernel"`` is one launch of the multi-cycle CUDA kernel
while N fits its ceiling (``kernels.autotune.MULTI_KERNEL_MAX_N``), and
otherwise a loop of per-cycle updates with the bookkeeping replayed after it
(one fused kernel launch per cycle on ``kernel`` and hybrid ``kernel``).  rtl
keeps the per-cycle step: one coupling-sum launch per slow-clock edge.

:func:`weighted_sum` also takes one coupling matrix per instance, (I, M, N)
against spins (I, B, N), on every backend (the Max-Cut annealer of
:mod:`repro_torch.core.ising`); :func:`async_sweep` is the sequential
Hopfield sweep of its oracle.

Under an active :class:`repro_torch.distributed.ShardPlan` (``with
plan.context(mesh):``) a model-sharded plan turns every weighted sum into a
row-sharded collective (:func:`_model_sharded_sum`: the backend per row
block of W on the ``"model"`` devices, lanes over ``"data"``, an exact
combine on the mesh's first device) and bypasses the kernels that need the
whole W (3, 4, 5, 7); a data-only plan advances each lane shard on its own
device (kernel 5 once per shard).  Both equal the unsharded solve.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import coupling as coupling_lib
from repro_torch.core import oscillator as osc
from repro_torch.core.checks import require_int_dtype, resolve_device
from repro_torch.core.quantization import check_weight_range
from repro_torch.distributed import sharding as shard_lib
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kernel_ref
from repro_torch.optim import compress

_BACKEND_NAMES = ("parallel", "serial", "kernel", "hybrid")
_HYBRID_IMPLS = ("scan", "kernel")

#: Auto ``parallel_factor`` (P) for ``backend="hybrid"`` when the config
#: leaves it 0 (the reference's value).
DEFAULT_PARALLEL_FACTOR = 32


@dataclasses.dataclass(frozen=True)
class ONNConfig:
    """Static configuration of one digital ONN instance.

    Same fields, defaults and validation as ``repro.core.dynamics.ONNConfig``;
    ``backend`` ∈ {parallel, serial, kernel, hybrid} and ``hybrid_impl`` ∈
    {scan, kernel}.  A bare ``serial_chunk > 0`` folds into
    ``backend="serial"`` and a bare ``parallel_factor > 0`` into
    ``backend="hybrid"``.
    """

    n: int
    weight_bits: int = 5
    phase_bits: int = 4
    architecture: str = "hybrid"  # "recurrent" | "hybrid"
    mode: str = "functional"  # "functional" | "rtl"
    max_cycles: int = 100
    sync_jitter: bool = False  # randomize enable-signal offset (rtl hybrid)
    backend: str = "parallel"  # "parallel" | "serial" | "kernel" | "hybrid"
    serial_chunk: int = 0  # block size for backend="serial" (0 → auto)
    #: MAC width P of the hybrid backend (0 → auto).
    parallel_factor: int = 0
    #: Execution route of the hybrid backend: "scan" or "kernel".
    hybrid_impl: str = "scan"
    #: Cycles between early-exit checks of the batched solve (0 → none).
    settle_chunk: int = 8
    #: Move phases across the kernel boundary two 4-bit counters per byte.
    phase_pack: bool = False

    def __post_init__(self) -> None:
        if self.architecture not in ("recurrent", "hybrid"):
            raise ValueError(f"unknown architecture {self.architecture!r}")
        if self.mode not in ("functional", "rtl"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.settle_chunk < 0:
            raise ValueError(f"settle_chunk must be >= 0, got {self.settle_chunk}")
        if self.backend == "parallel" and self.serial_chunk > 0:
            if self.parallel_factor > 0:
                raise ValueError(
                    "serial_chunk>0 and parallel_factor>0 are contradictory "
                    "route flags; pick backend='serial' or backend='hybrid' "
                    "explicitly"
                )
            object.__setattr__(self, "backend", "serial")
        elif self.backend == "parallel" and self.parallel_factor > 0:
            object.__setattr__(self, "backend", "hybrid")
        if self.backend not in _BACKEND_NAMES:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {_BACKEND_NAMES}"
            )
        if self.parallel_factor < 0:
            raise ValueError(
                f"parallel_factor must be >= 0, got {self.parallel_factor}"
            )
        if self.hybrid_impl not in _HYBRID_IMPLS:
            raise ValueError(
                f"unknown hybrid_impl {self.hybrid_impl!r}; expected one of "
                f"{_HYBRID_IMPLS}"
            )
        if self.backend != "serial" and self.serial_chunk > 0:
            raise ValueError(
                f"serial_chunk={self.serial_chunk} only applies to "
                f'backend="serial", not {self.backend!r}'
            )
        if self.backend != "hybrid":
            if self.parallel_factor > 0:
                raise ValueError(
                    f"parallel_factor={self.parallel_factor} only applies to "
                    f'backend="hybrid", not {self.backend!r}'
                )
            if self.hybrid_impl != "scan":
                raise ValueError(
                    f"hybrid_impl={self.hybrid_impl!r} only applies to "
                    f'backend="hybrid", not {self.backend!r}'
                )
        if self.phase_pack and self.phase_bits > 4:
            raise ValueError(
                f"phase_pack packs two phase counters per byte, which needs "
                f"phase_bits <= 4; got phase_bits={self.phase_bits}"
            )

    @property
    def clocks_per_cycle(self) -> int:
        return 1 << self.phase_bits

    @property
    def hybrid_parallel(self) -> int:
        """Resolved parallelism P of the hybrid schedule (clamped to n)."""
        p = self.parallel_factor if self.parallel_factor > 0 else DEFAULT_PARALLEL_FACTOR
        return min(p, self.n)

    @property
    def hybrid_passes(self) -> int:
        """Serialized MAC passes per phase update: ``ceil(n / P)``."""
        return -(-self.n // self.hybrid_parallel)


class OnnParams(NamedTuple):
    weights: torch.Tensor  # (N, N) int8 coupling matrix
    bias: torch.Tensor  # (N,) int32 per-oscillator field offset
    # W's row blocks placed for a ShardPlan (distributed.sharding.Placement,
    # set by shard_onn_params); None when W is not placed for one
    placement: Optional[Any] = None


class OnnState(NamedTuple):
    """Dynamical state of one single-lane run (0-d tensors for the flags)."""

    phase: torch.Tensor  # (N,) uint8 rotating-frame phase counters
    prev_phase: torch.Tensor  # (N,) phases one cycle earlier
    first_cycle: torch.Tensor  # bool: prev_phase not yet populated
    settle_cycle: torch.Tensor  # int32 first cycle with no phase change
    settled: torch.Tensor  # bool
    cycled: torch.Tensor  # bool: entered a period-2 orbit
    cycle: torch.Tensor  # int32 cycles elapsed


class ONNResult(NamedTuple):
    final_phase: torch.Tensor
    final_sigma: torch.Tensor
    settle_cycle: torch.Tensor
    settled: torch.Tensor
    cycled: torch.Tensor


class BatchState(NamedTuple):
    """Resumable state of the batched runner (all lanes-first).

    Each lane carries its own cycle clock ``t``, so a lane installed into a
    freed slot mid-solve replays exactly the trajectory of an isolated solve.
    ``aux``/``prev_aux``/``t0`` are the rtl carry: (B, N) lab-frame spins of
    the last slow-clock edge and the per-lane enable offsets; in functional
    mode ``aux`` is (B, 1) zeros and ``t0`` zeros.
    """

    phase: torch.Tensor  # (B, N) uint8 phases, cycle t
    prev_phase: torch.Tensor  # (B, N) phases, cycle t-1
    aux: torch.Tensor  # (B, N) int8 rtl lab spins one clock back; (B, 1) zeros otherwise
    prev_aux: torch.Tensor
    settle_cycle: torch.Tensor  # (B,) int32
    settled: torch.Tensor  # (B,) bool
    cycled: torch.Tensor  # (B,) bool
    frozen: torch.Tensor  # (B,) bool: lane provably on its final trajectory
    frozen_p2: torch.Tensor  # (B,) bool: frozen inside a period-2 orbit
    freeze_cycle: torch.Tensor  # (B,) int32 per-lane cycle count at freeze
    t: torch.Tensor  # (B,) int32 per-lane cycles elapsed
    t0: torch.Tensor  # (B,) int32 per-lane enable-signal offsets


# ---------------------------------------------------------------------------
# Params and masked-lane padding
# ---------------------------------------------------------------------------


def make_params(cfg: ONNConfig, weights, bias=None, device=None) -> OnnParams:
    """Validate and place a coupling matrix + bias as ``OnnParams``.

    ``weights``: (N, N) int8 (tensor or numpy); ``bias``: (N,) integers or
    None.  Tensors go to ``device``: the GPU unless ``device="cpu"``.
    """
    dev = resolve_device(device)
    weights = torch.as_tensor(weights)
    if tuple(weights.shape) != (cfg.n, cfg.n):
        raise ValueError(f"weights {tuple(weights.shape)} != ({cfg.n}, {cfg.n})")
    if weights.dtype != torch.int8:
        raise TypeError(f"weights must be int8, got {weights.dtype}")
    if bias is None:
        bias = torch.zeros((cfg.n,), dtype=torch.int32)
    else:
        bias = torch.as_tensor(require_int_dtype(bias, "bias")).to(torch.int32)
        if tuple(bias.shape) != (cfg.n,):
            raise ValueError(f"bias {tuple(bias.shape)} != ({cfg.n},)")
    return OnnParams(weights=weights.to(dev), bias=bias.to(dev))


def validate_weights(weights: torch.Tensor, bits: int) -> None:
    """Raise if the coupling matrix is out of the representable range."""
    if not bool(check_weight_range(weights, bits)):
        raise ValueError(f"coupling weights exceed {bits}-bit signed range")


def pad_config(cfg: ONNConfig, n_to: int) -> ONNConfig:
    """The same config at a bucketed oscillator count ``n_to`` ≥ cfg.n
    (a hybrid config freezes its resolved MAC width first)."""
    if n_to < cfg.n:
        raise ValueError(f"pad_config: n_to={n_to} < cfg.n={cfg.n}")
    if cfg.backend == "hybrid":
        return dataclasses.replace(cfg, n=n_to, parallel_factor=cfg.hybrid_parallel)
    return dataclasses.replace(cfg, n=n_to)


def pad_params(cfg: ONNConfig, params: OnnParams, n_to: int) -> OnnParams:
    """Zero-pad couplings and bias to (n_to, n_to): padded oscillators are
    uncoupled, so the first ``cfg.n`` evolve bit-exactly as unpadded."""
    if n_to < cfg.n:
        raise ValueError(f"pad_params: n_to={n_to} < cfg.n={cfg.n}")
    pad = n_to - cfg.n
    if pad == 0:
        return params
    return OnnParams(
        weights=F.pad(params.weights, (0, pad, 0, pad)),
        bias=F.pad(params.bias, (0, pad)),
    )


def pad_sigma(sigma: torch.Tensor, n_to: int, value: int = 1) -> torch.Tensor:
    """Pad ±1 spin patterns (..., n) to (..., n_to) with constant spins."""
    n = sigma.shape[-1]
    if n_to < n:
        raise ValueError(f"pad_sigma: n_to={n_to} < n={n}")
    if n_to == n:
        return sigma
    return F.pad(sigma, (0, n_to - n), value=value)


# ---------------------------------------------------------------------------
# Weighted-sum backends
# ---------------------------------------------------------------------------


def _parallel_sum(cfg: ONNConfig, w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    return coupling_lib.weighted_sum_parallel(w, sigma)


def _serial_sum(cfg: ONNConfig, w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    chunk = cfg.serial_chunk if cfg.serial_chunk > 0 else min(cfg.n, 64)
    return coupling_lib.weighted_sum_serial(w, sigma, chunk=chunk)


def _kernel_sum(cfg: ONNConfig, w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    return kernel_ops.coupling_sum(w, sigma)


def hybrid_mac_sum(w: torch.Tensor, sigma: torch.Tensor, parallel: int) -> torch.Tensor:
    """Serialized-MAC coupling sum (the hybrid datapath), pass by pass.

    Every row's N inputs are consumed in ``ceil(N / parallel)`` passes, each
    feeding ``parallel`` weights and spins into a P-wide MAC whose int32
    accumulator carries across passes; when P does not divide N the last
    pass runs with zero-padded (idle) lanes, which leaves the sum unchanged.
    Bit-exact with :func:`repro_torch.core.coupling.weighted_sum_parallel`
    for every P.  ``w``: (M, N) int8; ``sigma``: (..., N) int8 → (..., M)
    int32; or one matrix per instance, ``w`` (I, M, N) with ``sigma``
    (I, B, N) → (I, B, M).  The ``hybrid_impl="scan"`` route: the plain
    version of kernel 6 on any lead shape.
    """
    coupling_lib.check_shapes(w, sigma)
    return kernel_ref.hybrid_coupling_sum_ref(w, sigma, parallel)


def _hybrid_sum(cfg: ONNConfig, w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    if cfg.hybrid_impl == "kernel":
        return kernel_ops.hybrid_coupling_sum(w, sigma, parallel=cfg.hybrid_parallel)
    return hybrid_mac_sum(w, sigma, cfg.hybrid_parallel)


BACKENDS = {
    "parallel": _parallel_sum,
    "serial": _serial_sum,
    "kernel": _kernel_sum,
    "hybrid": _hybrid_sum,
}


def _model_plan():
    """The active (ShardPlan, Mesh) pair if the row-sharded collective is on.

    The reference discriminates its jit caches on ``_sharding_cache_key``;
    the port compiles nothing per call, so it has no counterpart: the plan
    is read from the thread-local context at each call (kernel launch plans
    are keyed by shape, so row blocks get their own).
    """
    plan, mesh = shard_lib.current_plan(), shard_lib.current_mesh()
    if plan is None or mesh is None or not plan.model_sharded:
        return None
    return plan, mesh


def _data_plan():
    """The active (ShardPlan, Mesh) pair if lanes split over ``"data"`` with
    W whole on each device (a data-only plan: ``Bx1`` or
    ``layout="replicated"``)."""
    plan, mesh = shard_lib.current_plan(), shard_lib.current_mesh()
    if plan is None or mesh is None or plan.model_sharded or plan.batch < 2:
        return None
    return plan, mesh


def _check_home(mesh, t: torch.Tensor) -> None:
    if t.device != mesh.first:
        raise ValueError(
            f"sharded solve: operands on {t.device}, but the mesh's first device "
            f"(where the combine runs) is {mesh.first}"
        )


def row_block_partials(
    cfg: ONNConfig, w: torch.Tensor, sigma: torch.Tensor, plan, mesh, placement=None
) -> list:
    """The partial fields of the row-sharded collective
    (:func:`_model_sharded_sum`): ``parts[i][j]`` is the configured backend's
    field of W's row block j (``ceil(M / model)`` rows, the last one shorter
    when M does not divide; an empty block runs nothing) on
    ``mesh.devices[i, j]`` against data shard i of σ — σ's leading axis
    (lanes, or instances with W's) split over ``"data"`` when the plan
    data-parallelizes and that axis divides it, else one shard.  The blocks
    are ``placement``'s when it was made for this W
    (``sharding.shard_onn_params``), else ``sharding.weight_blocks``'.
    """
    _check_home(mesh, sigma)
    lead = plan.batch > 1 and sigma.dim() >= 2 and sigma.shape[0] % plan.batch == 0
    shards = plan.batch if lead else 1
    size = sigma.shape[0] // shards
    blocks = shard_lib.weight_blocks(w, plan, mesh, data=shards, placement=placement)
    out = []
    for i in range(shards):
        s_i = sigma[i * size:(i + 1) * size] if lead else sigma
        parts = []
        for wb in blocks[i]:
            if wb.shape[-2] == 0:
                continue
            if lead and w.dim() == 3:
                wb = wb[i * size:(i + 1) * size]
            parts.append(BACKENDS[cfg.backend](cfg, wb, s_i.to(wb.device)))
        out.append(parts)
    return out


def _model_sharded_sum(
    cfg: ONNConfig, w: torch.Tensor, sigma: torch.Tensor, plan, mesh, placement=None
) -> torch.Tensor:
    """S = W σ as a row-sharded collective over the ``"model"`` axis.

    The software analogue of partitioning the coupling fabric across boards:
    W's rows are split over the ``"model"`` mesh axis, each device runs the
    *configured backend* on its row block against the full σ — so the kernel
    routes launch kernel 1 (or 6) per device — (:func:`row_block_partials`)
    and the partial fields are combined on the mesh's first device.  The
    blocks are disjoint, so the reference's ``psum`` of zero-filled buffers
    is a concatenation, exact for every backend at any N.  When M does not
    divide the model degree the last block is shorter: the reference's
    zero-padded rows would add zero columns that its final slice drops, so
    the port runs the real rows only.

    ``w`` may be a row slab (M < N rows — the Ising window path) or one
    matrix per instance, (I, M, N) with σ (I, B, N); σ keeps the full
    contraction width N.  When the plan also data-parallelizes, σ's leading
    axis splits over ``"data"`` and the shards' fields concatenate along it.
    ``plan.compressed`` swaps the exact combine for the int8 wire
    :func:`repro_torch.optim.compress.compressed_psum_scatter`.
    """
    home = sigma.device
    out = []
    for parts in row_block_partials(cfg, w, sigma, plan, mesh, placement):
        if plan.compressed:
            out.append(compress.compressed_psum_scatter(parts)[0].to(home))
        else:
            out.append(torch.cat([p.to(home) for p in parts], dim=-1))
    return torch.cat(out, dim=0) if len(out) > 1 else out[0]


def weighted_sum(
    cfg: ONNConfig, w: torch.Tensor, sigma: torch.Tensor, placement=None
) -> torch.Tensor:
    """S = W σ through the backend selected by ``cfg.backend``.

    ``w`` (M, N) with ``sigma`` (..., N) → (..., M) int32, or one matrix per
    instance, ``w`` (I, M, N) with ``sigma`` (I, B, N) → (I, B, M): the
    reference's ``jax.vmap`` over instances, written out (one kernel launch
    for all instances on the kernel routes).  Under an active model-sharded
    :class:`repro_torch.distributed.ShardPlan` the backend runs per device
    on its row block (:func:`_model_sharded_sum`), equal to the
    single-device sum; ``placement`` is W's placement for the plan
    (``OnnParams.placement``), without which the blocks are cut per call.
    """
    pm = _model_plan()
    if pm is not None:
        return _model_sharded_sum(cfg, w, sigma, *pm, placement=placement)
    return BACKENDS[cfg.backend](cfg, w, sigma)


def sign_update(field: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Hopfield sign dynamics with ties keeping the current spin."""
    return torch.where(
        field > 0, 1, torch.where(field < 0, -1, sigma.to(torch.int32))
    ).to(torch.int8)


# ---------------------------------------------------------------------------
# Functional-mode dynamics
# ---------------------------------------------------------------------------


def initial_phase(cfg: ONNConfig, sigma0: torch.Tensor) -> torch.Tensor:
    """Canonical phases (0 / half-period) for an initial spin pattern."""
    return osc.phase_of_spin(sigma0, cfg.phase_bits)


def functional_update(
    cfg: ONNConfig, params: OnnParams, phase: torch.Tensor
) -> torch.Tensor:
    """One synchronous phase update (rotating frame); ``phase``: (..., N).

    On ``backend="kernel"`` the whole cycle is one fused kernel launch
    (int8 product + bias + phase-align epilogue); with ``cfg.phase_pack``
    the launch takes the packed phases and derives σ in registers.  On the
    hybrid backend's ``kernel`` route it is one launch of kernel 7 (the
    serialized-MAC sum with the same epilogue).

    Under a model-sharded ShardPlan the fused whole-cycle launches are
    bypassed — they need the full square W — and the cycle runs as the
    coupling collective + bias + alignment; the coupling kernels (1, 6)
    still run, per device on their row block (:func:`_model_sharded_sum`).
    """
    half = osc.n_positions(cfg.phase_bits) // 2
    model_sharded = _model_plan() is not None
    if cfg.backend == "kernel" and not model_sharded:
        if cfg.phase_pack:
            return kernel_ops.phase_step_packed(
                params.weights, params.bias, phase, half=half
            )
        sigma = osc.spin(phase, cfg.phase_bits)
        return kernel_ops.phase_step(params.weights, sigma, params.bias, phase, half=half)
    sigma = osc.spin(phase, cfg.phase_bits)
    if cfg.backend == "hybrid" and cfg.hybrid_impl == "kernel" and not model_sharded:
        return kernel_ops.hybrid_phase_step(
            params.weights, sigma, params.bias, phase, half=half,
            parallel=cfg.hybrid_parallel,
        )
    s = weighted_sum(cfg, params.weights, sigma, params.placement) + params.bias
    return osc.phase_align(phase, s, cfg.phase_bits)


def _state_of_phase(cfg: ONNConfig, phase0: torch.Tensor) -> OnnState:
    dev = phase0.device
    return OnnState(
        phase=phase0,
        prev_phase=phase0,
        first_cycle=torch.tensor(True, device=dev),
        settle_cycle=torch.tensor(cfg.max_cycles, dtype=torch.int32, device=dev),
        settled=torch.tensor(False, device=dev),
        cycled=torch.tensor(False, device=dev),
        cycle=torch.tensor(0, dtype=torch.int32, device=dev),
    )


def init_state(cfg: ONNConfig, sigma0: torch.Tensor) -> OnnState:
    """Fresh dynamical state for an initial spin pattern."""
    return _state_of_phase(cfg, initial_phase(cfg, sigma0))


def step(cfg: ONNConfig, params: OnnParams, state: OnnState) -> OnnState:
    """One oscillation cycle of the synchronous (functional-mode) dynamics.

    The settle tests are ``all()`` over the whole phase array: one lane.
    """
    if cfg.mode != "functional":
        raise ValueError(
            "step() drives the synchronous functional-mode dynamics; "
            f"mode={cfg.mode!r} runs are only available through run()"
        )
    return _advance_state(state, functional_update(cfg, params, state.phase))


def _advance_state(state: OnnState, new_phase: torch.Tensor) -> OnnState:
    """The settle/period-2 bookkeeping of one cycle that ends on ``new_phase``
    (shared by ``step`` and the rtl cycle loop of ``run``)."""
    unchanged = torch.all(new_phase == state.phase)
    is_cycle2 = torch.all(new_phase == state.prev_phase) & ~unchanged & ~state.first_cycle
    settle = torch.where(unchanged & ~state.settled, state.cycle, state.settle_cycle)
    settled = state.settled | unchanged
    cycled = state.cycled | (is_cycle2 & ~settled)
    return OnnState(
        phase=new_phase,
        prev_phase=state.phase,
        first_cycle=torch.zeros_like(state.first_cycle),
        settle_cycle=settle,
        settled=settled,
        cycled=cycled,
        cycle=state.cycle + 1,
    )


def _result_of_state(cfg: ONNConfig, state: OnnState) -> ONNResult:
    return ONNResult(
        final_phase=state.phase,
        final_sigma=osc.spin(state.phase, cfg.phase_bits),
        settle_cycle=state.settle_cycle,
        settled=state.settled,
        cycled=state.cycled,
    )


def run(
    cfg: ONNConfig, params: OnnParams, phase0: torch.Tensor, t0: Optional[int] = None
) -> ONNResult:
    """Evolve one ONN for ``max_cycles`` cycles; ``phase0``: (N,) uint8.

    The fixed-length reference the batched solve is held against.  ``t0``
    is the lane's enable-signal offset in slow clocks: required by
    ``mode="rtl"`` with ``sync_jitter``, and must be None or 0 otherwise.
    """
    offset = _lane_offsets(cfg, None if t0 is None else [int(t0)], 1, phase0.device)
    if cfg.mode == "rtl":
        return _run_rtl(cfg, params, phase0, offset)
    state = _state_of_phase(cfg, phase0)
    for _ in range(cfg.max_cycles):
        state = step(cfg, params, state)
    return _result_of_state(cfg, state)


# ---------------------------------------------------------------------------
# RTL-mode dynamics
# ---------------------------------------------------------------------------


def _jitter(cfg: ONNConfig) -> bool:
    return cfg.mode == "rtl" and cfg.sync_jitter


def _lane_offsets(cfg: ONNConfig, t0, batch: int, device) -> torch.Tensor:
    """(B,) int32 per-lane enable offsets; zeros without jitter."""
    if t0 is None:
        if _jitter(cfg):
            raise ValueError(
                "mode='rtl' with sync_jitter needs t0, the per-lane enable-signal offsets"
            )
        return torch.zeros((batch,), dtype=torch.int32, device=device)
    t0 = torch.as_tensor(require_int_dtype(t0, "t0")).to(device=device, dtype=torch.int32)
    if tuple(t0.shape) != (batch,):
        raise ValueError(f"t0 {tuple(t0.shape)} != ({batch},)")
    if not _jitter(cfg) and bool(torch.any(t0 != 0)):
        raise ValueError("t0: enable offsets apply only to mode='rtl' with sync_jitter")
    return t0


def _lab_spins(cfg: ONNConfig, phase: torch.Tensor, ref_phase: torch.Tensor) -> torch.Tensor:
    """Lab-frame spins of rotating-frame ``phase`` when the reference sits at
    ``ref_phase`` (int32, broadcast over the last axis)."""
    theta_lab = (phase.to(torch.int32) + ref_phase) % cfg.clocks_per_cycle
    return osc.spin(theta_lab, cfg.phase_bits)


def _rtl_clock_edge(
    cfg: ONNConfig, params: OnnParams, phase: torch.Tensor, sigma_lab_prev: torch.Tensor,
    t: torch.Tensor,
):
    """One slow-clock edge in the lab frame; returns (phase, lab spins).

    ``t`` is the edge's index on the reference clock, an int32 tensor of the
    phase's lane shape: 0-d for one lane, (B,) for a batch.
    """
    clocks = cfg.clocks_per_cycle
    ref_phase = (t % clocks)[..., None]
    sign_ref = torch.where(ref_phase < clocks // 2, 1, -1).to(torch.int32)
    sigma_lab = _lab_spins(cfg, phase, ref_phase)
    # The hybrid's serialized sum consumed amplitudes from one slow clock
    # earlier; the recurrent adder tree is combinational (current amps).
    sigma_used = sigma_lab_prev if cfg.architecture == "hybrid" else sigma_lab
    s = weighted_sum(cfg, params.weights, sigma_used, params.placement) + params.bias
    # Reference level is absolute (high iff S > 0); aligning the oscillator
    # to it in the lab frame == rotating-frame target sign(S) * sign_ref.
    return osc.phase_align(phase, s * sign_ref, cfg.phase_bits), sigma_lab


def _run_rtl(
    cfg: ONNConfig, params: OnnParams, phase0: torch.Tensor, t0: torch.Tensor
) -> ONNResult:
    """Fixed-length rtl run of one lane (``t0``: its (1,) offset):
    ``max_cycles`` cycles of ``clocks_per_cycle`` edges, settle bookkeeping
    once per cycle."""
    clocks = cfg.clocks_per_cycle
    edges = t0 + torch.arange(cfg.max_cycles * clocks, dtype=torch.int32, device=t0.device)
    aux = _lab_spins(cfg, phase0, edges[0] % clocks)
    state = _state_of_phase(cfg, phase0)
    for cycle in range(cfg.max_cycles):
        phase = state.phase
        for k in range(clocks):
            phase, aux = _rtl_clock_edge(cfg, params, phase, aux, edges[cycle * clocks + k])
        state = _advance_state(state, phase)
    return _result_of_state(cfg, state)


# ---------------------------------------------------------------------------
# Batched-native dynamics: (B, N)-first solve with per-lane early exit
# ---------------------------------------------------------------------------
#
# A lane freezes when its full carry (phase, plus the rtl lab spins in
# ``aux``) reaches a fixed point or a period-2 orbit; a frozen lane's
# remaining cycles are known, and the phase the fixed-length scan would end on
# is recovered from the parity of the remaining cycle count
# (``_batch_result``).  In functional mode the aux carry is constant, so the
# per-cycle bookkeeping of ``_batch_step`` can be replayed after a chunk from
# the first fixed-point / period-2 event of each lane (``_chunk_fused``), or
# run inside the multi-cycle kernel (``_chunk_multi``); rtl runs
# ``_batch_step`` every cycle.


def _rtl_cycle_batch(
    cfg: ONNConfig,
    params: OnnParams,
    t0: torch.Tensor,
    t: torch.Tensor,
    phase: torch.Tensor,
    aux: torch.Tensor,
):
    """One oscillation cycle (``clocks_per_cycle`` slow-clock edges) of the
    rtl dynamics for all lanes at once.  ``t0``/``t``: (B,) int32 per-lane
    enable offsets and cycle counts, so a lane installed mid-slab sees its
    own edge sequence ``t0 + t * clocks + k``; ``phase`` (B, N) uint8,
    ``aux`` (B, N) int8 lab spins of the previous edge."""
    clocks = cfg.clocks_per_cycle
    base = t0.to(torch.int32) + t.to(torch.int32) * clocks
    for k in range(clocks):
        phase, aux = _rtl_clock_edge(cfg, params, phase, aux, base + k)
    return phase, aux


def _batch_step(cfg: ONNConfig, params: OnnParams, c: BatchState) -> BatchState:
    """One cycle of the batched dynamics + settle/freeze bookkeeping.

    Freezing compares the full carry: phase and, in rtl, the lab spins the
    hybrid consumes one slow clock later (``aux``)."""
    if cfg.mode == "functional":
        new_phase, new_aux = functional_update(cfg, params, c.phase), c.aux
    else:
        new_phase, new_aux = _rtl_cycle_batch(cfg, params, c.t0, c.t, c.phase, c.aux)
    t = c.t
    active = ~c.frozen & (t < cfg.max_cycles)
    not_first = t > 0
    lane_unchanged = torch.all(new_phase == c.phase, dim=-1)
    phase_p2 = torch.all(new_phase == c.prev_phase, dim=-1)
    is_cycle2 = phase_p2 & ~lane_unchanged & not_first
    settle_cycle = torch.where(active & lane_unchanged & ~c.settled, t, c.settle_cycle)
    settled = c.settled | (active & lane_unchanged)
    cycled = c.cycled | (active & is_cycle2 & ~settled)
    aux_unchanged = torch.all(new_aux == c.aux, dim=-1)
    aux_p2 = torch.all(new_aux == c.prev_aux, dim=-1)
    carry_fixed = lane_unchanged & aux_unchanged
    carry_p2 = phase_p2 & aux_p2 & ~carry_fixed & not_first
    newly_frozen = active & (carry_fixed | carry_p2)
    upd = active[:, None]
    return BatchState(
        phase=torch.where(upd, new_phase, c.phase),
        prev_phase=torch.where(upd, c.phase, c.prev_phase),
        aux=torch.where(upd, new_aux, c.aux),
        prev_aux=torch.where(upd, c.aux, c.prev_aux),
        settle_cycle=settle_cycle,
        settled=settled,
        cycled=cycled,
        frozen=c.frozen | newly_frozen,
        frozen_p2=c.frozen_p2 | (newly_frozen & carry_p2),
        freeze_cycle=torch.where(newly_frozen, t + 1, c.freeze_cycle),
        t=torch.where(active, t + 1, t),
        t0=c.t0,
    )


def _batch_result(cfg: ONNConfig, c: BatchState) -> ONNResult:
    """Final state → result, with the period-2 parity reconstruction: a lane
    frozen inside a period-2 orbit ends on ``prev_phase`` when the remaining
    cycle count ``max_cycles - freeze_cycle`` is odd."""
    parity_odd = ((cfg.max_cycles - c.freeze_cycle) % 2) == 1
    swap = c.frozen_p2 & parity_odd
    final_phase = torch.where(swap[:, None], c.prev_phase, c.phase)
    return ONNResult(
        final_phase=final_phase,
        final_sigma=osc.spin(final_phase, cfg.phase_bits),
        settle_cycle=c.settle_cycle,
        settled=c.settled,
        cycled=c.cycled,
    )


def _multi_kernel_eligible(cfg: ONNConfig) -> bool:
    """Whether one multi-cycle kernel launch can run this instance's chunk
    (``kernels.autotune.MULTI_KERNEL_MAX_N``: its per-lane state must fit a
    block's shared memory)."""
    return (
        cfg.mode == "functional"
        and cfg.backend == "kernel"
        and cfg.n <= autotune.MULTI_KERNEL_MAX_N
    )


def _chunk_multi(cfg: ONNConfig, params: OnnParams, c: BatchState, chunk: int) -> BatchState:
    """One settle-chunk as ONE multi-cycle kernel launch (backend="kernel")."""
    half = osc.n_positions(cfg.phase_bits) // 2
    (
        phase, prev_phase, settle_cycle, settled, cycled, frozen, frozen_p2,
        freeze_cycle, t,
    ) = kernel_ops.phase_step_multi(
        params.weights, params.bias, c.phase, c.prev_phase, c.t,
        c.settle_cycle, c.settled, c.cycled, c.frozen, c.frozen_p2,
        c.freeze_cycle,
        half=half, chunk=chunk, max_cycles=cfg.max_cycles, packed=cfg.phase_pack,
    )
    return c._replace(
        phase=phase,
        prev_phase=prev_phase,
        settle_cycle=settle_cycle,
        settled=settled,
        cycled=cycled,
        frozen=frozen,
        frozen_p2=frozen_p2,
        freeze_cycle=freeze_cycle,
        t=t,
    )


def _chunk_fused(cfg: ONNConfig, params: OnnParams, c: BatchState, chunk: int) -> BatchState:
    """One settle-chunk as a bare loop of phase updates + post-hoc exact
    bookkeeping from the first fixed-point/period-2 event of each lane
    (masked to its remaining cycle budget).  Frozen lanes apply 0 cycles."""
    traj = []
    ph = c.phase
    for _ in range(chunk):
        ph = functional_update(cfg, params, ph)
        traj.append(ph)
    ext = torch.stack([c.prev_phase, c.phase, *traj], dim=0)  # (chunk + 2, B, N)
    nxt, cur, prv = ext[2:], ext[1:-1], ext[:-2]
    unchanged = torch.all(nxt == cur, dim=-1)  # (chunk, B)
    p2 = torch.all(nxt == prv, dim=-1)
    tk = c.t[None, :] + torch.arange(chunk, dtype=torch.int32, device=c.t.device)[:, None]
    in_budget = tk < cfg.max_cycles
    fixed_evt = unchanged & in_budget
    p2_evt = p2 & ~unchanged & (tk > 0) & in_budget
    evt = fixed_evt | p2_evt
    any_evt = torch.any(evt, dim=0)
    # argmax over an int cast (torch rejects bool) takes the FIRST event.
    kf = torch.argmax(evt.to(torch.int32), dim=0).to(torch.int32)
    budget = torch.clamp(cfg.max_cycles - c.t, 0, chunk)
    applied = torch.where(any_evt, torch.minimum(kf + 1, budget), budget)
    applied = torch.where(c.frozen, torch.zeros_like(applied), applied)
    live_evt = any_evt & ~c.frozen
    kf_idx = kf.long()[None, :]
    is_fixed = live_evt & fixed_evt.gather(0, kf_idx)[0]
    is_p2 = live_evt & p2_evt.gather(0, kf_idx)[0]
    lanes = torch.arange(ext.shape[1], device=ext.device)
    sel = applied.long()
    new_prev = ext[sel, lanes]
    new_phase = ext[sel + 1, lanes]
    newly = is_fixed | is_p2
    return c._replace(
        phase=new_phase,
        prev_phase=new_prev,
        settle_cycle=torch.where(is_fixed & ~c.settled, c.t + kf, c.settle_cycle),
        settled=c.settled | is_fixed,
        cycled=c.cycled | is_p2,
        frozen=c.frozen | newly,
        frozen_p2=c.frozen_p2 | is_p2,
        freeze_cycle=torch.where(newly, c.t + kf + 1, c.freeze_cycle),
        t=c.t + applied,
    )


def _advance_local(
    cfg: ONNConfig, params: OnnParams, state: BatchState, chunk: int
) -> BatchState:
    """One settle-chunk of the slab on the device of its tensors."""
    if cfg.mode == "rtl":
        for _ in range(chunk):
            state = _batch_step(cfg, params, state)
        return state
    # The multi-cycle kernel needs the full square W, which a model-sharded
    # plan has split: the fused loop's weighted sums run the collective.
    if _multi_kernel_eligible(cfg) and _model_plan() is None:
        return _chunk_multi(cfg, params, state, chunk)
    return _chunk_fused(cfg, params, state, chunk)


def _advance_chunk_batched(
    cfg: ONNConfig, params: OnnParams, state: BatchState, chunk: int
) -> BatchState:
    """Advance the slab by one settle-chunk through the fastest exact route:
    in functional mode one multi-cycle kernel launch where eligible, else the
    fused loop; in rtl ``chunk`` per-cycle steps (the aux carry is live).

    Under a data-only ShardPlan whose batch divides the lanes, each lane
    shard advances on its ``"data"`` device against W's copy there (kernel 5
    once per shard on the kernel route); lanes never read each other, so the
    shards concatenate exactly on the first device, where the one host read
    of the early exit happens.
    """
    dp = _data_plan()
    b = state.phase.shape[0]
    if dp is None or b % dp[0].batch != 0:
        return _advance_local(cfg, params, state, chunk)
    plan, mesh = dp
    _check_home(mesh, state.phase)
    size = b // plan.batch
    blocks = shard_lib.weight_blocks(params.weights, plan, mesh, placement=params.placement)
    shards = []
    for i in range(plan.batch):
        w_i = blocks[i][0]
        sub = BatchState(*(x[i * size:(i + 1) * size].to(w_i.device) for x in state))
        shards.append(_advance_local(
            cfg, OnnParams(w_i, params.bias.to(w_i.device)), sub, chunk))
    home = state.phase.device
    return BatchState(*(torch.cat([s[k].to(home) for s in shards]) for k in range(len(state))))


def _init_carry(cfg: ONNConfig, phase0: torch.Tensor, t0=None) -> BatchState:
    """Fresh per-lane carry at t = 0; ``phase0``: (B, N), ``t0``: (B,) or None."""
    b, dev = phase0.shape[0], phase0.device
    t0 = _lane_offsets(cfg, t0, b, dev)
    if cfg.mode == "rtl":
        aux0 = _lab_spins(cfg, phase0, (t0 % cfg.clocks_per_cycle)[:, None])
    else:
        aux0 = torch.zeros((b, 1), dtype=torch.int8, device=dev)  # no amplitude history
    full = torch.full((b,), cfg.max_cycles, dtype=torch.int32, device=dev)
    false = torch.zeros((b,), dtype=torch.bool, device=dev)
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    return BatchState(
        phase=phase0,
        prev_phase=phase0,
        aux=aux0,
        prev_aux=aux0,
        settle_cycle=full,
        settled=false,
        cycled=false,
        frozen=false,
        frozen_p2=false,
        freeze_cycle=full,
        t=zeros,
        t0=t0,
    )


def resolve_chunk(cfg: ONNConfig) -> int:
    """Cycles per early-exit check: ``settle_chunk`` clamped to [1, max_cycles]."""
    chunk = cfg.settle_chunk if cfg.settle_chunk > 0 else cfg.max_cycles
    return max(1, min(chunk, cfg.max_cycles))


def _lane_done(cfg: ONNConfig, c: BatchState) -> torch.Tensor:
    """(B,) bool: lane frozen or out of cycle budget (its result is final)."""
    return c.frozen | (c.t >= cfg.max_cycles)


def _run_batched(cfg: ONNConfig, params: OnnParams, phase0: torch.Tensor, t0=None) -> ONNResult:
    """The batched early-exit runner; one host synchronisation per chunk."""
    state = _init_carry(cfg, phase0, t0)
    chunk = resolve_chunk(cfg)
    while not bool(torch.all(_lane_done(cfg, state))):
        state = _advance_chunk_batched(cfg, params, state, chunk)
    return _batch_result(cfg, state)


def run_batch(
    cfg: ONNConfig, params: OnnParams, phase0_batch: torch.Tensor, t0=None
) -> ONNResult:
    """Evolve a (B, N) batch of phase states to steady state, early-exiting;
    bit-exact, lane for lane, with :func:`run` over the same inputs.

    ``t0``: (B,) int32 per-lane enable offsets, required by ``mode="rtl"``
    with ``sync_jitter`` (lane i equals ``run(..., t0=t0[i])``); any other
    config takes None or zeros.
    """
    return _run_batched(cfg, params, phase0_batch, t0)


def retrieve(
    cfg: ONNConfig, params: OnnParams, sigma0_batch: torch.Tensor, t0=None
) -> ONNResult:
    """Run a (B, N) batch of initial ±1 spin patterns to steady state
    (``t0`` as in :func:`run_batch`)."""
    return _run_batched(cfg, params, initial_phase(cfg, sigma0_batch), t0)


# ---------------------------------------------------------------------------
# Resumable chunked solve: the continuous-batching entry points
# ---------------------------------------------------------------------------


def init_batch_state(cfg: ONNConfig, phase0_batch: torch.Tensor, t0=None) -> BatchState:
    """Fresh :class:`BatchState` for a (B, N) batch of phase states at t = 0
    (``t0`` as in :func:`run_batch`)."""
    return _init_carry(cfg, phase0_batch, t0)


def dead_batch_state(cfg: ONNConfig, batch: int, device=None) -> BatchState:
    """An all-frozen (batch, N) placeholder slab whose lanes never advance;
    :func:`install_lanes` overwrites slots with real requests."""
    dev = resolve_device(device)
    aux_n = cfg.n if cfg.mode == "rtl" else 1
    full = torch.full((batch,), cfg.max_cycles, dtype=torch.int32, device=dev)
    zeros_ph = torch.zeros((batch, cfg.n), dtype=torch.uint8, device=dev)
    zeros_aux = torch.zeros((batch, aux_n), dtype=torch.int8, device=dev)
    false = torch.zeros((batch,), dtype=torch.bool, device=dev)
    return BatchState(
        phase=zeros_ph,
        prev_phase=zeros_ph,
        aux=zeros_aux,
        prev_aux=zeros_aux,
        settle_cycle=full,
        settled=false,
        cycled=false,
        frozen=torch.ones((batch,), dtype=torch.bool, device=dev),
        frozen_p2=false,
        freeze_cycle=full,
        t=full,
        t0=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def install_lanes(state: BatchState, sub: BatchState, slots) -> BatchState:
    """Scatter the lanes of ``sub`` (width K) into ``state`` at rows ``slots``.

    Returns a new state; untouched rows keep their values bit-identical.
    """
    idx = torch.as_tensor(slots, dtype=torch.long, device=state.phase.device)

    def put(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out = a.clone()
        out[idx] = b
        return out

    return BatchState(*(put(a, b) for a, b in zip(state, sub)))


def advance_chunk(cfg: ONNConfig, params: OnnParams, state: BatchState) -> BatchState:
    """Advance every live lane by one settle-chunk of cycles; frozen or
    budget-exhausted lanes are no-ops."""
    return _advance_chunk_batched(cfg, params, state, resolve_chunk(cfg))


def batch_done(cfg: ONNConfig, state: BatchState) -> torch.Tensor:
    """(B,) bool: which lanes are final (frozen or out of cycle budget)."""
    return _lane_done(cfg, state)


def batch_result(cfg: ONNConfig, state: BatchState) -> ONNResult:
    """Results for a slab; valid per lane once :func:`batch_done` is True."""
    return _batch_result(cfg, state)


def async_sweep(w: torch.Tensor, sigma: torch.Tensor, order) -> torch.Tensor:
    """One asynchronous (sequential) Hopfield sweep: σ_i ← sign(Σ_j W_ij σ_j)
    for each i of ``order`` in turn, ties keeping σ_i.

    ``w`` (N, N), ``sigma`` (N,), ``order`` a sequence or tensor of vertex
    indices; returns a new spin vector in ``sigma``'s dtype, on its device.
    Integer couplings accumulate exactly, in int64 (the reference's int32
    holds every field too: |field| ≤ N · 128); float couplings accumulate in
    ``promote_types(w.dtype, float32)``, since truncating them to an integer
    type would zero sub-unit fields and flip sign decisions near zero (the
    accumulator rule of ``repro.core.dynamics.async_sweep``).  One host loop
    step per visit, with no synchronisation: the index comes from the host.
    """
    if w.dtype.is_floating_point:
        acc = torch.promote_types(w.dtype, torch.float32)
    else:
        require_int_dtype(w, "w")
        acc = torch.int64
    wa = w.to(acc)
    s = sigma.clone()
    idx = order.tolist() if isinstance(order, torch.Tensor) else list(order)
    for i in idx:
        field = (wa[i] * s.to(acc)).sum()
        s[i] = torch.where(field > 0, 1, torch.where(field < 0, -1, s[i].to(torch.int64)))
    return s
