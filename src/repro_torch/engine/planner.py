"""Time-to-solution planner: pick bucket slabs, quote latencies (the port of
``repro.engine.planner``: the same EMA and cost-rate fit).

The paper's central trade is time-to-solution vs. resources: the recurrent
design is fast per cycle but caps at 48 oscillators; the hybrid serializes
the MAC to reach 506 at ~100× lower oscillation frequency (Figs 11–12).
The serving engine faces the same trade per drain: a big batch slab
amortizes dispatch overhead (throughput) but pads more lanes; a small slab
answers sooner (latency).  This planner makes that choice measurable:

* **EMA latencies** — every executed slab updates an exponential moving
  average of wall seconds per (instance, bucket) key; warm estimates come
  from here.
* **Model-based cold start** — before a bucket has ever run, its cost is
  the solver's abstract unit count (e.g. lanes · N² · cycles for an ONN
  retrieve) converted to seconds through a globally fitted cost rate, so
  even the first request gets a quote of the right order.
* **FPGA context** — estimates carry ``fpga_seconds`` from
  ``repro_torch.core.hardware_model.time_to_solution`` when the workload maps onto the
  paper's designs, putting every software latency next to the hardware it
  models.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Mapping, Optional, Sequence, Tuple

from repro_torch.engine import bucketing

#: Cold-start cost rate (seconds per abstract unit) before any measurement:
#: the order of one fused int8 MAC on a CPU core (the reference's value).  The first observation
#: replaces it, so it only shapes the very first quote.
DEFAULT_COST_RATE = 2e-9


@dataclasses.dataclass(frozen=True)
class Estimate:
    """A per-request (or per-slab) latency quote.

    ``units`` is the solver's abstract work estimate behind a model-sourced
    quote.  For ONN retrieval it is lanes · N² · *expected* cycles, where the
    expected cycle count blends the worst-case ``max_cycles`` with the
    measured settle-cycle EMA (``adapters.RetrievalEngineSolver``) — the
    early-exit batched solve stops when lanes freeze, so quotes tighten
    toward executed work as traffic flows instead of assuming the scan bound.

    ``fpga_tradeoff`` is the paper's architecture trade quoted per request:
    a mapping of design labels (e.g. ``"recurrent"``, ``"hybrid[P=1]"``,
    ``"hybrid[P=32]"``) to their hardware time-to-solution in seconds, with
    ``None`` marking designs that do not fit the FPGA budget at this N —
    the fast-but-small recurrent vs slow-but-large hybrid choice, made
    visible next to every software latency quote.  Past one board's hybrid
    capacity a partitioned multi-FPGA point ``"hybrid[K=4,P=1]"`` (coupling
    rows over K boards, inter-board amplitude exchange per update) joins
    the quote — see ``hardware_model.partitioned_time_to_solution``.
    """

    seconds: float
    source: str  # "ema" (measured) | "model" (cost-rate cold start)
    fpga_seconds: Optional[float] = None  # paper-hardware time-to-solution
    units: float = 0.0  # abstract work behind a model quote (0 if unknown)
    #: Per-design hardware quotes (None value: design does not fit at this N).
    fpga_tradeoff: Optional[Mapping[str, Optional[float]]] = None


class Planner:
    """Bucket-slab planner with per-bucket EMA latencies.

    One planner per engine; keys are whatever the engine uses to identify a
    slab shape — (instance, bucket signature, batch bucket).
    """

    def __init__(
        self,
        batch_buckets: Sequence[int] = bucketing.DEFAULT_BATCH_BUCKETS,
        ema_alpha: float = 0.3,
    ) -> None:
        if not 0.0 < ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha={ema_alpha} outside (0, 1]")
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.ema_alpha = ema_alpha
        self._ema_s: Dict[Hashable, float] = {}
        self._cost_rate = DEFAULT_COST_RATE
        self._rate_fitted = False

    # -- planning ----------------------------------------------------------

    def plan(self, lanes: int) -> Tuple[int, ...]:
        """Chop ``lanes`` pending lanes into batch-bucket slabs."""
        return bucketing.chop(lanes, self.batch_buckets)

    # -- measurement -------------------------------------------------------

    def observe(self, key: Hashable, seconds: float, units: float = 0.0) -> None:
        """Record a measured slab execution (and refit the cost rate).

        The first observation of a key is dominated by one-time work (kernel
        builds and launch plans on first use), so it seeds that key's EMA
        but is excluded from the global cost-rate fit — cold-start quotes
        for *other* shapes should reflect steady-state execution.
        """
        prev = self._ema_s.get(key)
        a = self.ema_alpha
        self._ema_s[key] = seconds if prev is None else (1 - a) * prev + a * seconds
        if prev is not None and units > 0 and seconds > 0:
            rate = seconds / units
            if not self._rate_fitted:
                self._cost_rate, self._rate_fitted = rate, True
            else:
                self._cost_rate = (1 - a) * self._cost_rate + a * rate

    # -- quoting -----------------------------------------------------------

    def estimate(
        self,
        key: Hashable,
        units: float = 0.0,
        fpga_seconds: Optional[float] = None,
        fpga_tradeoff: Optional[Mapping[str, Optional[float]]] = None,
    ) -> Estimate:
        """Latency quote for one slab at ``key``: EMA if measured, else model."""
        ema = self._ema_s.get(key)
        if ema is not None:
            return Estimate(
                seconds=ema,
                source="ema",
                fpga_seconds=fpga_seconds,
                units=units,
                fpga_tradeoff=fpga_tradeoff,
            )
        return Estimate(
            seconds=units * self._cost_rate,
            source="model",
            fpga_seconds=fpga_seconds,
            units=units,
            fpga_tradeoff=fpga_tradeoff,
        )

    def snapshot(self) -> Dict[str, object]:
        """Planner state for ``Engine.stats()``."""
        return {
            "cost_rate_s_per_unit": self._cost_rate,
            "cost_rate_fitted": self._rate_fitted,
            "ema_seconds": {repr(k): v for k, v in self._ema_s.items()},
        }
