"""Analytic FPGA resource & frequency model (paper §4.2, §5, Figs 9–12):
the port's copy of ``repro.core.hardware_model``.

The paper's hardware-scaling results are reproduced with a *structural*
cost model: it counts the architectural elements each design instantiates
(adders, registers, multiplexers, MACs, memory ports) and converts them to
LUT/FF/DSP/BRAM totals with per-element costs calibrated once against the
paper's published endpoints:

  * recurrent @ N=48:  LUT 49 441, FF 13 906, DSP 0, BRAM 0     (Table 4)
  * hybrid    @ N=506: LUT 41 547, FF 44 748, DSP 220, BRAM 140 (Table 4)
  * recurrent f_osc(48) = 625 kHz, hybrid f_osc(506) = 6.1 kHz  (Table 5)

The *structure* (what scales as N², N·log N, N) is derived from the RTL
description in the paper, not fitted.  Every function, constant and
rounding step is the reference's, so every value is equal to its value
(``tests/test_torch_hardware_model.py``); the port keeps a copy because the
reference module cannot be imported without JAX.  ``repro_torch.engine``
quotes :func:`time_to_solution` beside its own latency estimates.

Zynq-7020 budget (PYNQ-Z2): 53 200 LUT, 106 400 FF, 220 DSP, 140 BRAM36.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

ZYNQ_7020 = {
    "lut": 53_200,
    "ff": 106_400,
    "dsp": 220,
    "bram": 140,
}


@dataclasses.dataclass(frozen=True)
class BitConfig:
    weight_bits: int = 5
    phase_bits: int = 4

    @property
    def registers_per_oscillator(self) -> int:
        return 1 << self.phase_bits


def _acc_width(n: int, weight_bits: int) -> int:
    """Accumulator width for N signed weight_bits-wide addends."""
    qmax = (1 << (weight_bits - 1)) - 1
    return math.ceil(math.log2(n * qmax + 1)) + 1


# ---------------------------------------------------------------------------
# Calibrated per-element costs (LUT/FF per structural unit).  These are the
# ONLY free constants; each is pinned by one paper endpoint (see module doc).
# ---------------------------------------------------------------------------
_RA_LUT_PER_ADDER_BIT = 2.7128  # adder-tree LUTs per result bit (endpoint: 49441@48)
_RA_LUT_PER_OSC = 10.0  # mux + edge detector + counter per oscillator
_RA_FF_PER_ADDER = 0.71720  # pipeline/fanout FFs per adder (endpoint: 13906@48)

_HA_LUT_CONTROL_PER_OSC = 27.5087  # CDC sync, counters, result-hold (endpoint: 41547@506)
_HA_LUT_MUX_COEF = 2.2  # N:1 amplitude mux LUT6 tree incl. routing replication
_HA_FF_CONTROL_PER_OSC = 34.4348  # (endpoint: 44748@506)
_HA_MACS_PER_DSP = 2.3  # 5-bit SIMD packing in the 25×18 DSP48 (endpoint: 220@506)
_HA_MACS_PER_BRAM = 3.62  # dual-port × packed reads (endpoint: 140@506)
_HA_LOGIC_CLOCK_HZ = 50e6  # Table 5
_RA_OSC_F0 = 625e3 * 48**0.4614  # power-law anchor through Table 5 + Fig 11 slope
_RA_FREQ_SLOPE = -0.4614  # Fig 11 (recurrent)
_HA_FMAX_REF = 50e6  # fast-clock fmax at N=506
_HA_FMAX_SLOPE = -0.3515  # logic fmax degradation; combined slope ≈ −1.35 (Fig 11)
_HA_SERIAL_OVERHEAD = 2  # reset + result-hold fast clocks


def recurrent_resources(n: int, bits: BitConfig = BitConfig()) -> Dict[str, int]:
    """LUT/FF/DSP/BRAM of the recurrent (fully parallel) architecture.

    Structure: N rows × (N−1) combinational adders of growing width (the
    adder-tree result reaches acc_width bits) + N² weight registers (FFs,
    there is no addressable memory) + per-oscillator shift register, phase
    counter and edge detector.
    """
    w = bits.weight_bits
    acc = _acc_width(n, w)
    # Mean adder width across the balanced tree ≈ (w + acc) / 2.
    lut = (
        n * (n - 1) * ((w + acc) / 2.0) * _RA_LUT_PER_ADDER_BIT
        + n * _RA_LUT_PER_OSC
    )
    ff = (
        n * n * w  # weight matrix held in registers
        + n * bits.registers_per_oscillator  # circular shift registers
        + n * (n - 1) * _RA_FF_PER_ADDER  # adder-tree pipeline/fanout registers
    )
    return {"lut": int(round(lut)), "ff": int(round(ff)), "dsp": 0, "bram": 0}


def _check_parallel(n: int, parallel: int) -> int:
    if parallel <= 0:
        raise ValueError(f"parallel must be positive, got {parallel}")
    return min(parallel, n)


def hybrid_resources(
    n: int, bits: BitConfig = BitConfig(), parallel: int = 1
) -> Dict[str, int]:
    """LUT/FF/DSP/BRAM of the hybrid (serialized MAC) architecture.

    Structure per oscillator: ``parallel`` accumulating MAC lanes (acc_width
    bits, mapped with the multipliers into DSP slices, SIMD-packed), an N:1
    single-bit amplitude multiplexer (LUT6 ⇒ ~N/64 LUTs at scale), an
    address counter (log2 N bits), weight storage in BRAM (port-limited:
    P reads per fast clock per row), plus control.  ``parallel`` is the
    datapath width P of ``ONNConfig.parallel_factor``: P=1 is the paper's
    single-MAC design (Table 4 pins this endpoint exactly); larger P adds
    DSP/BRAM-port cost ∝ N·P plus a (P−1)-adder reduction tree per row
    (costed at the recurrent model's per-adder-bit rate, so P→N recovers
    the recurrent adder-tree scaling).
    """
    w = bits.weight_bits
    acc = _acc_width(n, w)
    addr = max(1, math.ceil(math.log2(n)))
    p = _check_parallel(n, parallel)
    macs = n * p
    lut = n * (
        2.0 * acc  # accumulator + sign/compare logic outside the DSP
        + _HA_LUT_MUX_COEF * math.ceil(n / 64)  # N:1 amplitude mux (LUT6 tree + routing)
        + addr  # address decode
        + _HA_LUT_CONTROL_PER_OSC
        # P-wide MAC reduction tree: (P − 1) adders per row, mean width as
        # in the recurrent adder-tree model (zero at the paper's P=1).
        + (p - 1) * ((w + acc) / 2.0) * _RA_LUT_PER_ADDER_BIT
    )
    ff = n * (
        bits.registers_per_oscillator  # circular shift register
        + acc  # accumulator register
        + addr  # fast-clock counter
        + (acc + 1)  # result-hold register
        + _HA_FF_CONTROL_PER_OSC  # CDC synchronizers, control FSM
        + (p - 1) * _RA_FF_PER_ADDER  # reduction-tree pipeline registers
    )
    # The epsilon keeps an exact ratio (506 / 2.3 = 220) from rounding up a
    # slice on float error — Table 4's 220 DSPs is the binding budget at 506.
    dsp = math.ceil(macs / _HA_MACS_PER_DSP - 1e-9)
    bram_ports = math.ceil(macs / _HA_MACS_PER_BRAM - 1e-9)
    bram_capacity = math.ceil(n * n * w / 36_864)  # BRAM36 = 36 kib
    bram = max(bram_ports, bram_capacity)
    return {"lut": int(round(lut)), "ff": int(round(ff)), "dsp": dsp, "bram": bram}


def resources(
    arch: str, n: int, bits: BitConfig = BitConfig(), parallel: int = 1
) -> Dict[str, int]:
    if arch == "recurrent":
        return recurrent_resources(n, bits)
    if arch == "hybrid":
        return hybrid_resources(n, bits, parallel)
    raise ValueError(f"unknown architecture {arch!r}")


def oscillation_frequency(
    arch: str, n: int, bits: BitConfig = BitConfig(), parallel: int = 1
) -> float:
    """Oscillation frequency in Hz at network size N (paper Fig 11, Table 5).

    ``parallel`` (hybrid only) is the MAC width P: each phase update costs
    ``ceil(N / P) + overhead`` fast clocks, so widening the datapath buys
    oscillation frequency at the resource cost ``hybrid_resources`` models.
    """
    if arch == "recurrent":
        return _RA_OSC_F0 * n**_RA_FREQ_SLOPE
    if arch == "hybrid":
        # fast-clock fmax degrades with design size; each phase update costs
        # (ceil(N/P) + overhead) fast clocks; a period is 2**phase_bits updates.
        p = _check_parallel(n, parallel)
        fmax = _HA_FMAX_REF * (506.0 / n) ** (-_HA_FMAX_SLOPE)
        updates_per_period = 1 << bits.phase_bits
        passes = -(-n // p)
        return fmax / (updates_per_period * (passes + _HA_SERIAL_OVERHEAD))
    raise ValueError(f"unknown architecture {arch!r}")


def time_to_solution(
    arch: str,
    n: int,
    cycles: float,
    bits: BitConfig = BitConfig(),
    parallel: int = 1,
) -> float:
    """Seconds the FPGA design needs for ``cycles`` oscillation cycles.

    The paper's time-to-solution currency (Table 7 reports settle *cycles*;
    wall time is cycles / f_osc).  ``parallel`` threads the hybrid MAC
    width P through (P=1 — the paper's design — for recurrent or default).
    ``repro_torch.engine`` quotes this next to its own software estimates so every
    served request carries the hardware trade-study context (fast-but-small
    recurrent vs slow-but-large hybrid, interpolated by P).
    """
    return cycles / oscillation_frequency(arch, n, bits, parallel)


# Place-and-route stops short of 100 % LUT utilization (paper Table 4: the
# recurrent design fails routing beyond 92.9 % LUTs); dedicated blocks
# (DSP/BRAM) place at 100 %.
_ROUTE_CEILING = {"lut": 0.93, "ff": 1.0, "dsp": 1.0, "bram": 1.0}


def fits(
    arch: str, n: int, bits: BitConfig = BitConfig(), budget=None, parallel: int = 1
) -> bool:
    budget = budget or ZYNQ_7020
    r = resources(arch, n, bits, parallel)
    return all(
        r[k] <= budget[k] * _ROUTE_CEILING[k] for k in ("lut", "ff", "dsp", "bram")
    )


def max_oscillators(
    arch: str, bits: BitConfig = BitConfig(), budget=None, parallel: int = 1
) -> int:
    """Largest N that fits the FPGA budget (paper Table 5: 48 vs 506).

    ``parallel`` > 1 trades hybrid capacity for oscillation frequency: the
    P-wide datapath burns DSP/BRAM ports ∝ N·P, pulling the capacity point
    down from 506 toward the recurrent regime.
    """
    budget = budget or ZYNQ_7020
    lo, hi = 1, 1
    while fits(arch, hi, bits, budget, parallel):
        lo, hi = hi, hi * 2
        if hi > 1 << 20:
            break
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if fits(arch, mid, bits, budget, parallel):
            lo = mid
        else:
            hi = mid
    return lo


# ---------------------------------------------------------------------------
# Partitioned multi-FPGA hybrid (the paper §6 outlook: row-sharding the
# coupling matrix over K boards — the hardware twin of the software
# ShardPlan model axis of the reference's repro.distributed).
# ---------------------------------------------------------------------------

#: Single-bit amplitudes exchanged per inter-board link clock (one 64-wide
#: LVDS-class parallel link; each update every board must learn all N
#: amplitudes before its next MAC sweep).
_PARTITION_LINK_WIDTH = 64
#: Candidate board counts: powers of two up to a rack's worth.
_PARTITION_BOARDS = (2, 4, 8, 16, 32, 64)


def partitioned_resources(
    n: int, boards: int, bits: BitConfig = BitConfig(), parallel: int = 1
) -> Dict[str, int]:
    """Per-board LUT/FF/DSP/BRAM of an N-oscillator hybrid split over K boards.

    Row partition: each board owns ``r = ceil(N / K)`` oscillators — their
    P-wide MAC lanes, accumulators and weight rows — but every row still
    sums over all N columns, so the datapath *widths* (accumulator,
    amplitude mux, address counter) and the BRAM row length stay functions
    of the full N; only the per-oscillator replication count drops to r.
    ``boards = 1`` reduces exactly to :func:`hybrid_resources`.
    """
    if boards <= 0:
        raise ValueError(f"boards must be positive, got {boards}")
    w = bits.weight_bits
    acc = _acc_width(n, w)
    addr = max(1, math.ceil(math.log2(n)))
    p = _check_parallel(n, parallel)
    r = -(-n // boards)  # rows on the fullest board
    macs = r * p
    lut = r * (
        2.0 * acc
        + _HA_LUT_MUX_COEF * math.ceil(n / 64)
        + addr
        + _HA_LUT_CONTROL_PER_OSC
        + (p - 1) * ((w + acc) / 2.0) * _RA_LUT_PER_ADDER_BIT
    )
    ff = r * (
        bits.registers_per_oscillator
        + acc
        + addr
        + (acc + 1)
        + _HA_FF_CONTROL_PER_OSC
        + (p - 1) * _RA_FF_PER_ADDER
    )
    dsp = math.ceil(macs / _HA_MACS_PER_DSP - 1e-9)
    bram_ports = math.ceil(macs / _HA_MACS_PER_BRAM - 1e-9)
    bram_capacity = math.ceil(r * n * w / 36_864)  # each board stores r rows
    bram = max(bram_ports, bram_capacity)
    return {"lut": int(round(lut)), "ff": int(round(ff)), "dsp": dsp, "bram": bram}


def partition_fits(
    n: int,
    boards: int,
    bits: BitConfig = BitConfig(),
    budget=None,
    parallel: int = 1,
) -> bool:
    """Does each board of the K-way row partition fit its own budget?"""
    budget = budget or ZYNQ_7020
    r = partitioned_resources(n, boards, bits, parallel)
    return all(
        r[k] <= budget[k] * _ROUTE_CEILING[k] for k in ("lut", "ff", "dsp", "bram")
    )


def min_boards(
    n: int, bits: BitConfig = BitConfig(), budget=None, parallel: int = 1
):
    """Smallest power-of-two board count whose partition fits, else ``None``.

    ``1`` when the single-board hybrid already fits (no partition needed);
    ``None`` when even 64 boards cannot hold N — per-board cost has an
    N-proportional floor (full-width mux + BRAM row length per oscillator),
    so capacity does not scale to arbitrary N by adding boards alone.
    """
    if fits("hybrid", n, bits, budget, parallel):
        return 1
    for k in _PARTITION_BOARDS:
        if partition_fits(n, k, bits, budget, parallel):
            return k
    return None


def partitioned_time_to_solution(
    n: int,
    boards: int,
    cycles: float,
    bits: BitConfig = BitConfig(),
    parallel: int = 1,
) -> float:
    """Seconds for ``cycles`` oscillation cycles on the K-board partition.

    The fast-clock fmax recovers with the *per-board* design size (routing
    congestion is local to a board), but every phase update now pays an
    inter-board exchange: ``ceil(N / link_width)`` fast clocks to broadcast
    the new single-bit amplitudes over the 64-wide board-to-board link
    before the next MAC sweep — the hardware analogue of the software
    collective's psum.  ``boards = 1`` reduces to
    ``time_to_solution("hybrid", ...)``.
    """
    if boards <= 0:
        raise ValueError(f"boards must be positive, got {boards}")
    p = _check_parallel(n, parallel)
    r = -(-n // boards)
    fmax = _HA_FMAX_REF * (506.0 / max(r, 1)) ** (-_HA_FMAX_SLOPE)
    updates_per_period = 1 << bits.phase_bits
    passes = -(-n // p)
    exchange = 0 if boards == 1 else -(-n // _PARTITION_LINK_WIDTH)
    f_osc = fmax / (updates_per_period * (passes + exchange + _HA_SERIAL_OVERHEAD))
    return cycles / f_osc


def utilization(
    arch: str, n: int, bits: BitConfig = BitConfig(), budget=None, parallel: int = 1
) -> Dict[str, float]:
    budget = budget or ZYNQ_7020
    r = resources(arch, n, bits, parallel)
    return {k: r[k] / budget[k] for k in ("lut", "ff", "dsp", "bram")}


# Static infrastructure around the ONN core (AXI interconnect, control
# registers, host interface) — included in the Fig-12 *total* area aggregate
# but not in the per-design resource tables (which report the ONN core).
_INFRA_OVERHEAD = {"lut": 2500, "ff": 4000, "dsp": 8, "bram": 6}


def area_fraction(arch: str, n: int, bits: BitConfig = BitConfig(), budget=None) -> float:
    """Paper Fig 12 aggregate: arithmetic mean of the four utilizations,
    including the static infrastructure overhead of the full design."""
    budget = budget or ZYNQ_7020
    r = resources(arch, n, bits)
    return sum(
        (r[k] + _INFRA_OVERHEAD[k]) / budget[k] for k in ("lut", "ff", "dsp", "bram")
    ) / 4.0


def loglog_slope(xs, ys) -> tuple[float, float]:
    """OLS fit of log10(y) on log10(x): returns (slope, r_squared)."""
    import numpy as np

    lx, ly = np.log10(np.asarray(xs, float)), np.log10(np.asarray(ys, float))
    a = np.vstack([lx, np.ones_like(lx)]).T
    coef, res, *_ = np.linalg.lstsq(a, ly, rcond=None)
    pred = a @ coef
    ss_res = float(np.sum((ly - pred) ** 2))
    ss_tot = float(np.sum((ly - ly.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return float(coef[0]), r2
