"""Engine adapters: retrieval, max-cut and LM decode behind one surface (the
port of ``repro.engine.adapters``).

Each adapter implements :class:`repro_torch.engine.engine.EngineSolver`: it
maps request payloads to shape buckets, packs lanes from many requests into
one padded batch, and runs that batch through one batched solve on the
device of its solver.  Retrieval and max-cut register with
:mod:`repro_torch.engine.registry` from ``repro_torch.api``, beside the
``Solver`` classes they wrap; "lm" registers here.

Randomness follows the isolated solve.  A request's ``torch.Generator`` is
drawn from exactly as ``RetrievalSolver.solve`` / ``MaxCutSolver.solve``
draw from it for that request alone, at the request's true size, and the
draws are then padded to the bucket; so every served request equals its
isolated solve with a generator of the same seed, under every bucket
policy, occupancy and packing.

Nothing here waits on the card per request: payloads are gathered into one
host-to-device copy per slab where they lie on the host, results are split
per request as views of the slab's tensors, and the retrieval settle-cycle
EMA reads one number per slab (or per harvest of a streaming slab).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dynamics
from repro_torch.core import hardware_model as hw
from repro_torch.core import ising as ising_lib
from repro_torch.core.checks import resolve_device
from repro_torch.engine import bucketing
from repro_torch.engine.registry import register_solver
from repro_torch.kernels import autotune


def _fpga_design_tradeoff(
    n: int, cycles: float, bits: hw.BitConfig, parallel: int
) -> Dict[str, Optional[float]]:
    """Per-design hardware quotes for one instance (paper Table 5 trade).

    Labels map to time-to-solution seconds, or None when the design does
    not fit the FPGA budget at this N — the fast-but-small recurrent
    against the slow-but-large hybrid, plus the configured P-wide hybrid
    when the backend serializes with ``parallel`` > 1.  Once N exceeds one
    board's hybrid capacity, each non-fitting hybrid design additionally
    quotes its cheapest partitioned sibling ``hybrid[K=k,P=p]`` — the
    coupling rows split over the fewest boards that fit
    (``hw.min_boards``), paying the per-update inter-board amplitude
    exchange ``hw.partitioned_time_to_solution`` models.
    """
    designs: Dict[str, Tuple[str, int]] = {
        "recurrent": ("recurrent", 1),
        "hybrid[P=1]": ("hybrid", 1),
    }
    if parallel > 1:
        designs[f"hybrid[P={parallel}]"] = ("hybrid", parallel)
    quotes: Dict[str, Optional[float]] = {
        label: (
            hw.time_to_solution(arch, n, cycles, bits, parallel=par)
            if hw.fits(arch, n, bits, parallel=par)
            else None
        )
        for label, (arch, par) in designs.items()
    }
    for label, (arch, par) in designs.items():
        if arch != "hybrid" or quotes[label] is not None:
            continue
        k = hw.min_boards(n, bits, parallel=par)
        if k is not None and k > 1:
            quotes[f"hybrid[K={k},P={par}]"] = hw.partitioned_time_to_solution(
                n, k, cycles, bits, parallel=par
            )
    return quotes


def _gather(tensors: List[torch.Tensor], device: torch.device, stack: bool) -> torch.Tensor:
    """Concatenate (or stack) ``tensors`` onto ``device``: on the host first
    and in one copy when they all lie on the CPU, else each moved."""
    join = torch.stack if stack else torch.cat
    if all(t.device.type == "cpu" for t in tensors):
        return join(tensors).to(device)
    return join([t.to(device) for t in tensors])


def _rows(payload: Any) -> torch.Tensor:
    """A retrieval payload, (N,) or (B, N) ±1 spins, as (B, N) int8."""
    x = torch.as_tensor(payload)
    return (x[None] if x.dim() == 1 else x).to(torch.int8)


# ---------------------------------------------------------------------------
# Retrieval: batched associative memory (paper Fig. 7) on a fixed trained ONN
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class RetrievalSlab:
    """One in-flight continuous-batching slab (padded config + live state).

    Held by a serving scheduler between ticks; ``state`` is replaced (not
    mutated) by :meth:`RetrievalEngineSolver.admit` / ``advance``, so each
    tick is a function of the previous state.
    """

    cfg: dynamics.ONNConfig
    params: dynamics.OnnParams
    state: dynamics.BatchState
    width: int


class RetrievalEngineSolver:
    """Serves (B, N) corrupted-pattern batches on one trained coupling matrix.

    Payload: ``(N,)`` or ``(B, N)`` ±1 spins (tensor or numpy).  Lanes from
    different requests coalesce; the oscillator count is padded to the N
    bucket with masked (zero-coupled) oscillators, which is bit-exact on the
    real lanes (``repro_torch.core.dynamics.pad_params``), and a slab's
    unused rows are dead lanes of σ = +1 that never touch a real lane.  One
    padded instance is kept per N bucket.

    A slab solve is one call of the batched ``retrieve`` (the slab advances
    a settle-chunk at a time and exits once every lane freezes).  With
    ``mode="rtl"`` and ``sync_jitter`` each request's enable offsets are
    drawn from its generator as ``RetrievalSolver.solve`` draws them,
    ``torch.randint(0, clocks_per_cycle, (lanes,), generator=key)`` on the
    generator's device; every other config draws nothing.  Every slab feeds
    an EMA of the *measured* settle cycles back into :meth:`cost_units`, so
    latency quotes start at the worst-case ``max_cycles`` and tighten
    toward observed behaviour as traffic flows.

    ``xi=`` (P, N) ±1 patterns in place of ``solver=`` trains DO-I couplings
    on them (:meth:`repro_torch.api.RetrievalSolver.from_patterns`, which
    takes the remaining keyword arguments: ``device`` and config fields).
    """

    #: EMA smoothing for observed per-slab mean settle cycles.
    SETTLE_EMA_ALPHA = 0.3
    #: Blend ramp: after k observed slabs the EMA carries k/(k+WARMUP) of the
    #: quoted cycle count (the rest stays on the worst-case max_cycles).
    SETTLE_WARMUP = 8.0

    def __init__(self, solver: Optional[Any] = None, xi: Any = None, **cfg_kwargs: Any):
        from repro_torch.api import RetrievalSolver  # local: api imports this module

        if solver is None:
            if xi is None:
                raise ValueError("RetrievalEngineSolver needs solver= or xi=")
            solver = RetrievalSolver.from_patterns(xi, **cfg_kwargs)
        elif cfg_kwargs or xi is not None:
            raise TypeError("pass either a built solver or xi= + config kwargs")
        self.solver = solver
        self._padded: Dict[int, Tuple[dynamics.ONNConfig, dynamics.OnnParams]] = {}
        self._settle_ema: Optional[float] = None
        self._settle_obs: int = 0
        self._swaps: int = 0

    @property
    def config(self) -> dynamics.ONNConfig:
        return self.solver.config

    @property
    def device(self) -> torch.device:
        return self.solver.params.weights.device

    def lane_count(self, payload: Any) -> int:
        arr = torch.as_tensor(payload)
        return 1 if arr.dim() == 1 else arr.shape[0]

    def signature(self, payload: Any) -> Hashable:
        n = torch.as_tensor(payload).shape[-1]
        if n != self.config.n:
            raise ValueError(f"payload N={n} != solver N={self.config.n}")
        return n

    def bucket(self, signature: int, n_policy: bucketing.NBucketPolicy) -> int:
        return bucketing.bucket_n(signature, n_policy)

    def _padded_instance(self, n_bucket: int):
        if n_bucket not in self._padded:
            cfg_b = dynamics.pad_config(self.config, n_bucket)
            params_b = dynamics.pad_params(self.config, self.solver.params, n_bucket)
            self._padded[n_bucket] = (cfg_b, params_b)
        return self._padded[n_bucket]

    def _draws_randomness(self) -> bool:
        return self.config.mode == "rtl" and self.config.sync_jitter

    def _offsets(self, key: Optional[torch.Generator], lanes: int) -> torch.Tensor:
        """One request's (lanes,) enable offsets, drawn as
        ``RetrievalSolver.solve`` draws them, on the solver's device."""
        if not isinstance(key, torch.Generator):
            raise ValueError(
                "mode='rtl' with sync_jitter draws each request's enable offsets; "
                f"the request needs a torch.Generator, got {type(key).__name__}"
            )
        t0 = torch.randint(
            0, self.config.clocks_per_cycle, (lanes,), generator=key,
            device=key.device, dtype=torch.int32,
        )
        return t0.to(self.device)

    def install_params(self, params: dynamics.OnnParams) -> None:
        """Hot-install freshly trained weights of the same shape.

        The solver config and its launch plans are untouched; padded
        per-bucket instances are rebuilt for the buckets already touched.
        Live streaming slabs are *not* rewritten: a :class:`RetrievalSlab`
        keeps the params it began with, so in-flight lanes finish on the
        weights they started with.
        """
        cfg = self.config
        weights = torch.as_tensor(params.weights)
        if tuple(weights.shape) != (cfg.n, cfg.n):
            raise ValueError(
                f"hot swap shape mismatch: weights {tuple(weights.shape)} != ({cfg.n}, {cfg.n})"
            )
        if weights.dtype != torch.int8:
            raise TypeError(f"hot swap needs int8 weights, got {weights.dtype}")
        bias = torch.as_tensor(params.bias)
        if tuple(bias.shape) != (cfg.n,):
            raise ValueError(f"hot swap shape mismatch: bias {tuple(bias.shape)} != ({cfg.n},)")
        dynamics.validate_weights(weights, cfg.weight_bits)
        params = dynamics.OnnParams(
            weights=weights.to(self.device), bias=bias.to(self.device, torch.int32)
        )
        self.solver = dataclasses.replace(self.solver, params=params)
        for nb in list(self._padded):
            cfg_b, _ = self._padded[nb]
            self._padded[nb] = (cfg_b, dynamics.pad_params(cfg, params, nb))
        self._swaps += 1

    def _request_result(self, res: dynamics.ONNResult, rows, payload: Any):
        """One request's ``rows`` (a slice: views; or an index tensor) of a
        slab-wide result, cut to the true N."""
        n = self.config.n
        r = dynamics.ONNResult(
            final_phase=res.final_phase[rows, :n],
            final_sigma=res.final_sigma[rows, :n],
            settle_cycle=res.settle_cycle[rows],
            settled=res.settled[rows],
            cycled=res.cycled[rows],
        )
        if torch.as_tensor(payload).dim() == 1:  # single-lane payload → unbatched
            r = dynamics.ONNResult(*(x[0] for x in r))
        return r

    def solve_bucket(
        self,
        bucket_sig: int,
        payloads: List[Any],
        keys: List[torch.Generator],
        batch_bucket: int,
    ) -> List[Any]:
        cfg_b, params_b = self._padded_instance(bucket_sig)
        dev = self.device
        lanes2d = [_rows(p) for p in payloads]
        counts = [x.shape[0] for x in lanes2d]
        batch = dynamics.pad_sigma(_gather(lanes2d, dev, stack=False), bucket_sig)
        total = batch.shape[0]
        if total < batch_bucket:  # dead rows: live lanes of σ = +1, never read
            pad_rows = torch.ones((batch_bucket - total, bucket_sig), dtype=torch.int8, device=dev)
            batch = torch.cat([batch, pad_rows])

        t0 = None
        if self._draws_randomness():
            draws = [self._offsets(k, c) for k, c in zip(keys, counts)]
            draws.append(torch.zeros((batch_bucket - total,), dtype=torch.int32, device=dev))
            t0 = torch.cat(draws)

        res = dynamics.retrieve(cfg_b, params_b, batch, t0=t0)
        self._observe_settle(res, total)
        out: List[Any] = []
        offset = 0
        for p, c in zip(payloads, counts):
            out.append(self._request_result(res, slice(offset, offset + c), p))
            offset += c
        return out

    # -- streaming slab protocol (continuous batching) -----------------------
    #
    # A scheduler holds a RetrievalSlab per (N bucket, width), advances it one
    # settle-chunk per tick, harvests lanes as they freeze, and installs
    # queued requests into the freed slots.  Bit-exactness with
    # ``solve_bucket`` holds lane for lane: ``admit`` draws a request's enable
    # offsets exactly as the batch path does, and the core's per-lane clocks
    # make an installed lane replay its isolated trajectory whenever it joins.

    def begin_slab(self, bucket_sig: int, width: int) -> RetrievalSlab:
        """A fresh all-dead slab of ``width`` lanes at the N bucket."""
        cfg_b, params_b = self._padded_instance(bucket_sig)
        return RetrievalSlab(
            cfg=cfg_b,
            params=params_b,
            state=dynamics.dead_batch_state(cfg_b, width, device=self.device),
            width=width,
        )

    def admit(
        self,
        slab: RetrievalSlab,
        slots: Sequence[int],
        payload: Any,
        key: Optional[torch.Generator] = None,
    ) -> None:
        """Install one request's lanes into freed slab slots at t = 0."""
        lanes2d = _rows(payload).to(self.device)
        if len(slots) != lanes2d.shape[0]:
            raise ValueError(f"{len(slots)} slots for {lanes2d.shape[0]} lanes")
        sigma = dynamics.pad_sigma(lanes2d, slab.cfg.n)
        t0 = self._offsets(key, lanes2d.shape[0]) if self._draws_randomness() else None
        sub = dynamics.init_batch_state(slab.cfg, dynamics.initial_phase(slab.cfg, sigma), t0)
        slab.state = dynamics.install_lanes(slab.state, sub, list(slots))

    def advance(self, slab: RetrievalSlab) -> None:
        """Advance every live lane by one settle-chunk."""
        slab.state = dynamics.advance_chunk(slab.cfg, slab.params, slab.state)

    def done_mask(self, slab: RetrievalSlab) -> np.ndarray:
        """(width,) host bool array: lanes whose results are final."""
        return dynamics.batch_done(slab.cfg, slab.state).cpu().numpy()

    def results(self, slab: RetrievalSlab) -> dynamics.ONNResult:
        """Slab-wide results on the host (once per harvest tick, then
        ``extract``); the caller has already waited on ``done_mask``."""
        return dynamics.ONNResult(
            *(x.cpu() for x in dynamics.batch_result(slab.cfg, slab.state))
        )

    def extract(
        self, res: dynamics.ONNResult, slots: Sequence[int], payload: Any
    ) -> dynamics.ONNResult:
        """One request's result rows out of a slab-wide ``results``."""
        idx = torch.as_tensor(list(slots), dtype=torch.long, device=res.settled.device)
        return self._request_result(res, idx, payload)

    def observe(self, res: dynamics.ONNResult, slots: Sequence[int]) -> None:
        """Feed harvested lanes into the settle-cycle EMA (streaming path)."""
        idx = torch.as_tensor(list(slots), dtype=torch.long, device=res.settled.device)
        self._observe_settle(dynamics.ONNResult(*(x[idx] for x in res)), len(slots))

    # -- measured settle-cycle cost model ----------------------------------

    def _observe_settle(self, res: Any, lanes: int) -> None:
        """Fold one slab's (or one harvest's) measured settle cycles into the
        EMA (real lanes only; unsettled/cycled lanes are charged the worst
        case).  One host read of the mean: on the one-shot path after the
        slab's solve, which has synced on every chunk; on the streaming path
        the rows are already on the host."""
        if lanes <= 0:
            return
        mc = self.config.max_cycles
        eff = torch.where(res.settled[:lanes], res.settle_cycle[:lanes] + 1, mc)
        mean_eff = float(eff.to(torch.float32).mean())
        a = self.SETTLE_EMA_ALPHA
        self._settle_ema = (
            mean_eff if self._settle_ema is None else (1 - a) * self._settle_ema + a * mean_eff
        )
        self._settle_obs += 1

    def expected_cycles(self, block: bool = False) -> float:
        """Quoted oscillation cycles per solve: worst-case ``max_cycles``
        blended toward the measured settle-cycle EMA as slabs are observed
        (the early-exit batched solve really does stop at the EMA, so the
        quote converges on executed work instead of the cycle bound).
        ``block`` is accepted as the reference takes it, and changes
        nothing: each slab's mean is folded as it is observed, so nothing
        is pending."""
        del block
        mc = float(self.config.max_cycles)
        if self._settle_ema is None:
            return mc
        c = self._settle_obs / (self._settle_obs + self.SETTLE_WARMUP)
        return c * min(self._settle_ema, mc) + (1.0 - c) * mc

    def stats(self) -> Dict[str, Any]:
        """Measured settle-cycle state (surfaced by ``Engine.stats()``)."""
        return {
            "max_cycles": self.config.max_cycles,
            "settle_ema_cycles": self._settle_ema,
            "settle_slabs_observed": self._settle_obs,
            "expected_cycles": round(self.expected_cycles(), 3),
            "hot_swaps": self._swaps,
            "n_buckets": sorted(self._padded),
            # Hit/miss counts of the kernels' launch planners (one plan a shape).
            "autotune": {
                "multi_plan": autotune.multi_plan.cache_info()._asdict(),
                "coupling_plan": autotune.coupling_plan.cache_info()._asdict(),
            },
        }

    def _hybrid_parallel(self) -> int:
        """MAC width P of the configured datapath (1 off the hybrid backend)."""
        cfg = self.config
        return cfg.hybrid_parallel if cfg.backend == "hybrid" else 1

    def cost_units(self, bucket_sig: int, batch_bucket: int) -> float:
        cfg = self.config
        if cfg.backend == "hybrid":
            # The serialized schedule charges the full pass grid, idle ragged-
            # tail MAC lanes included: ceil(N/P) passes of P lanes per row.
            p = min(cfg.hybrid_parallel, bucket_sig)
            per_cycle = bucket_sig * (-(-bucket_sig // p)) * p
        else:
            per_cycle = bucket_sig * bucket_sig
        cycles = self.expected_cycles() * (cfg.clocks_per_cycle if cfg.mode == "rtl" else 1)
        return float(batch_bucket) * per_cycle * cycles

    def _bits(self) -> hw.BitConfig:
        return hw.BitConfig(self.config.weight_bits, self.config.phase_bits)

    @functools.cached_property
    def _fpga_quote(self) -> Tuple[Optional[float], Dict[str, Optional[float]]]:
        """(time-to-solution, per-design trade) of the paper hardware, once:
        it runs the *unpadded* instance, so the quote depends on the config
        alone (which a hot swap keeps), never on the bucket or the traffic."""
        cfg, bits, par = self.config, self._bits(), self._hybrid_parallel()
        return (
            hw.time_to_solution(cfg.architecture, cfg.n, cfg.max_cycles, bits, parallel=par),
            _fpga_design_tradeoff(cfg.n, cfg.max_cycles, bits, par),
        )

    def fpga_seconds(self, bucket_sig: int) -> Optional[float]:
        # The design at the configured serialized-MAC width (P=1 unless backend=hybrid).
        return self._fpga_quote[0]

    def fpga_tradeoff(self, bucket_sig: int) -> Dict[str, Optional[float]]:
        """Per-design hardware quotes for this instance (paper Table 5 trade);
        see :func:`_fpga_design_tradeoff`."""
        return dict(self._fpga_quote[1])


# ---------------------------------------------------------------------------
# Max-cut: batched oscillatory Ising machine (paper §2.2)
# ---------------------------------------------------------------------------


class MaxCutEngineSolver:
    """Serves (n, n) adjacency matrices; one lane per request.

    Instances are padded to the N bucket with isolated (zero-degree)
    vertices, marked past each instance's ``true_n`` so that they are never
    updated.  Each request's uniforms are drawn from its generator at its
    true n, ``torch.rand((replicas, n))`` then ``torch.rand((sweeps, n))``,
    the draws ``MaxCutSolver.solve`` makes for that instance alone, and then
    padded; nothing is drawn at the bucket's N.  So a request served here
    equals ``MaxCutSolver.solve(adjacency, key=<a generator with the same
    seed>)`` on every field for integer edge weights, under every bucket
    policy and occupancy; requests of different true n coalesce inside one
    bucket, and a slab's unused rows are empty graphs with ``true_n`` 0.
    (For other weights the cut fields are float32 sums over the padded
    matrix and agree within the bound ``ising.cut_value_exact`` states.)

    Each request runs ``replicas`` anneals of ``sweeps`` grouped-staggered
    sweeps through the configured ``backend`` (parallel / serial / kernel /
    hybrid with ``parallel_factor``), with optional per-replica early exit on
    cut-value ``stagnation``.  ``device`` is the port's device rule: the GPU
    unless ``"cpu"``.  One config is kept per N bucket touched.
    """

    def __init__(
        self,
        solver: Optional[Any] = None,
        sweeps: int = 64,
        weight_bits: int = 5,
        replicas: int = 1,
        stagger_groups: int = 0,
        stagnation: int = 0,
        backend: str = "parallel",
        parallel_factor: int = 0,
        hybrid_impl: str = "scan",
        settle_chunk: int = 8,
        device: Optional[str] = None,
    ):
        if solver is not None:  # wrap an api.MaxCutSolver's settings
            sweeps, weight_bits = solver.sweeps, solver.weight_bits
            replicas, stagger_groups = solver.replicas, solver.stagger_groups
            stagnation, backend = solver.stagnation, solver.backend
            parallel_factor = solver.parallel_factor
            hybrid_impl, settle_chunk = solver.hybrid_impl, solver.settle_chunk
            device = solver.device
        self.sweeps = int(sweeps)
        self.weight_bits = int(weight_bits)
        self.replicas = int(replicas)
        self.stagger_groups = int(stagger_groups)
        self.stagnation = int(stagnation)
        self.parallel_factor = int(parallel_factor)
        self.hybrid_impl = str(hybrid_impl)
        self.settle_chunk = int(settle_chunk)
        self.device = device
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        # Probe config: validates the backend/route combination once and
        # normalizes legacy spellings (parallel_factor>0 selects hybrid).
        probe = dynamics.ONNConfig(
            n=max(1, self.parallel_factor),
            weight_bits=self.weight_bits,
            max_cycles=self.sweeps,
            backend=str(backend),
            parallel_factor=self.parallel_factor,
            hybrid_impl=self.hybrid_impl,
            settle_chunk=self.settle_chunk,
        )
        self.backend = probe.backend
        self._cfgs: Dict[int, dynamics.ONNConfig] = {}  # bounded: one per N bucket
        self._fpga: Dict[int, Tuple[Optional[float], Dict[str, Optional[float]]]] = {}

    def _bucket_config(self, n_bucket: int) -> dynamics.ONNConfig:
        if n_bucket not in self._cfgs:
            self._cfgs[n_bucket] = dynamics.ONNConfig(
                n=n_bucket,
                weight_bits=self.weight_bits,
                max_cycles=self.sweeps,
                backend=self.backend,
                parallel_factor=self.parallel_factor,
                hybrid_impl=self.hybrid_impl,
                settle_chunk=self.settle_chunk,
            )
        return self._cfgs[n_bucket]

    def lane_count(self, payload: Any) -> int:
        return 1

    def signature(self, payload: Any) -> Hashable:
        shape = tuple(torch.as_tensor(payload).shape)
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError(f"max-cut payload must be square, got {shape}")
        return shape[0]

    def bucket(self, signature: int, n_policy: bucketing.NBucketPolicy) -> int:
        return bucketing.bucket_n(signature, n_policy)

    def solve_bucket(
        self,
        bucket_sig: int,
        payloads: List[Any],
        keys: List[torch.Generator],
        batch_bucket: int,
    ) -> List[Any]:
        nb = bucket_sig
        cfg = self._bucket_config(nb)
        dev = resolve_device(self.device)
        adjs = [torch.as_tensor(p) for p in payloads]
        dtype = functools.reduce(torch.promote_types, (a.dtype for a in adjs))
        padded, inits, orders, true_n = [], [], [], []
        for a, key in zip(adjs, keys):
            if not isinstance(key, torch.Generator):
                raise ValueError(
                    "max-cut draws its initial spins and sweep orders; the request "
                    f"needs a torch.Generator, got {type(key).__name__}"
                )
            n = a.shape[0]
            pad = nb - n
            init = torch.rand((self.replicas, n), generator=key, device=key.device)
            order = torch.rand((self.sweeps, n), generator=key, device=key.device)
            padded.append(F.pad(a.to(dtype), (0, pad, 0, pad)))
            inits.append(F.pad(init, (0, pad), value=1.0))
            orders.append(F.pad(order, (0, pad), value=1.0))
            true_n.append(n)
        dead = batch_bucket - len(adjs)  # dead rows: empty graphs, no vertices
        adjacency = _gather(padded, dev, stack=True)
        init_u = _gather(inits, dev, stack=True)
        sweep_u = _gather(orders, dev, stack=True)
        if dead > 0:
            adjacency = torch.cat([adjacency, adjacency.new_zeros((dead, nb, nb))])
            init_u = torch.cat([init_u, init_u.new_ones((dead, self.replicas, nb))])
            sweep_u = torch.cat([sweep_u, sweep_u.new_ones((dead, self.sweeps, nb))])
        res = ising_lib.solve_maxcut_batch(
            cfg,
            adjacency,
            init_u,
            sweep_u,
            stagger_groups=self.stagger_groups,
            stagnation=self.stagnation,
            true_n=torch.tensor(true_n + [0] * dead, dtype=torch.int32, device=dev),
        )
        return [
            ising_lib.MaxCutResult(
                sigma=res.sigma[i, :n],
                cut_value=res.cut_value[i],
                trace=res.trace[i],
                replica_cuts=res.replica_cuts[i],
                sweeps_run=res.sweeps_run[i],
            )
            for i, n in enumerate(true_n)
        ]

    def stats(self) -> Dict[str, Any]:
        """Static solve parameters (surfaced by ``Engine.stats()``)."""
        return {
            "sweeps": self.sweeps,
            "replicas": self.replicas,
            "stagger_groups": self.stagger_groups,
            "stagnation": self.stagnation,
            "backend": self.backend,
            "n_buckets_compiled": sorted(self._cfgs),
        }

    def _hybrid_parallel(self, n: int) -> int:
        cfg = self._bucket_config(n)
        return cfg.hybrid_parallel if cfg.backend == "hybrid" else 1

    def _cycles(self) -> float:
        # One staggered sweep ≈ one oscillation cycle (every oscillator's
        # enable fires once per period); replicas anneal back to back.
        return float(self.sweeps * self.replicas)

    def _bits(self) -> hw.BitConfig:
        return hw.BitConfig(weight_bits=self.weight_bits)

    def cost_units(self, bucket_sig: int, batch_bucket: int) -> float:
        """Executed work of one slab: each of a sweep's K update groups
        evaluates the field only at its ceil(N/K)-row member window, so a
        full sweep streams K·ceil(N/K) ≥ N coupling rows — on the hybrid
        backend each row costs the full pass grid (ceil(N/P) passes of P MAC
        lanes, idle tail included)."""
        cfg = self._bucket_config(bucket_sig)
        if cfg.backend == "hybrid":
            p = min(cfg.hybrid_parallel, bucket_sig)
            per_row = (-(-bucket_sig // p)) * p
        else:
            per_row = bucket_sig
        k = ising_lib.resolve_stagger_groups(self.stagger_groups, bucket_sig)
        rows_per_sweep = k * (-(-bucket_sig // k))
        return float(batch_bucket) * self.replicas * self.sweeps * rows_per_sweep * per_row

    def _fpga_quote(
        self, bucket_sig: int
    ) -> Tuple[Optional[float], Dict[str, Optional[float]]]:
        """(time-to-solution, per-design trade) at one N bucket, computed on
        its first request: it depends on the bucket and the settings alone."""
        if bucket_sig not in self._fpga:
            bits, par = self._bits(), self._hybrid_parallel(bucket_sig)
            self._fpga[bucket_sig] = (
                hw.time_to_solution("hybrid", bucket_sig, self._cycles(), bits, parallel=par),
                _fpga_design_tradeoff(bucket_sig, self._cycles(), bits, par),
            )
        return self._fpga[bucket_sig]

    def fpga_seconds(self, bucket_sig: int) -> Optional[float]:
        return self._fpga_quote(bucket_sig)[0]

    def fpga_tradeoff(self, bucket_sig: int) -> Dict[str, Optional[float]]:
        """Per-design hardware quotes for an Ising request — the recurrent-vs-
        hybrid trade, as for retrieval; see :func:`_fpga_design_tradeoff`."""
        return dict(self._fpga_quote(bucket_sig)[1])


# ---------------------------------------------------------------------------
# LM decode: the transformer serving loop as an engine workload
# ---------------------------------------------------------------------------


def _prompt_rows(payload: Dict[str, Any]) -> torch.Tensor:
    """An LM payload's prompt tokens, (L,) or (B, L), as (B, L) int32."""
    toks = torch.as_tensor(payload["tokens"])
    return (toks[None] if toks.dim() == 1 else toks).to(torch.int32)


class LMEngineSolver:
    """Serves prompt → greedy-decode requests for one model instance.

    Payload: ``{"tokens": (L,) or (B, L) int, "max_new_tokens": int}``,
    plus ``"vision"`` ((Nv, vision_dim) or (B, Nv, vision_dim)) for the VLM
    and ``"frames"`` ((T_enc, d_model) or (B, T_enc, d_model)) for the
    enc-dec family.
    Buckets are (prompt_len, max_new_tokens, extras); lanes coalesce along
    batch, padded lanes decode zero prompts whose outputs are dropped (batch
    rows are independent, so real lanes are unaffected).  ``extras`` names
    any other payload key; each extra is concatenated along the batch and
    zero-padded for the padded lanes, as the tokens are.  A VLM request
    without ``vision``, an enc-dec request without ``frames``, a ``frames``
    payload to any other family, and a Zamba or xLSTM prompt that is not a
    whole number of SSD chunks (``ssm_chunk``) are refused.

    The weights are drawn by ``params.materialize`` from the CPU
    ``generator`` and placed on ``device`` (the GPU unless ``"cpu"``), or
    given as a built model (``params=``, e.g. from
    ``repro_torch.convert.lm_params_from_reference``).  Requests' generators
    are not drawn from: greedy decode is deterministic and the decode cache
    starts at zero.  A request's result is its (max_new_tokens,) or (B,
    max_new_tokens) int32 tokens, on the CPU.
    """

    def __init__(
        self,
        arch: str,
        generator: Optional[torch.Generator] = None,
        reduced: bool = True,
        device=None,
        params: Optional[torch.nn.Module] = None,
    ) -> None:
        from repro_torch import configs
        from repro_torch.models import params as PM
        from repro_torch.models import steps as steps_lib
        from repro_torch.models.model import get_model

        if (generator is None) == (params is None):
            raise ValueError("LMEngineSolver takes exactly one of generator= and params=")
        self.arch = arch
        self.cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
        self.model = get_model(self.cfg)
        if params is None:
            tree = PM.materialize(self.model.param_specs, generator, device)
            params = self.model.build_params(tree)
        elif params.cfg != self.cfg:
            raise ValueError(f"params are built for {params.cfg.name}, not {self.cfg.name}")
        self.params = params
        self.device = params.device
        self._generate = steps_lib.make_generate(self.model)
        self.last_timing: Dict[str, float] = {}
        #: Per-slab timings since construction (a drain may run many slabs).
        self.timings: List[Dict[str, float]] = []

    def lane_count(self, payload: Dict[str, Any]) -> int:
        toks = torch.as_tensor(payload["tokens"])
        return 1 if toks.dim() == 1 else toks.shape[0]

    def signature(self, payload: Dict[str, Any]) -> Hashable:
        toks = torch.as_tensor(payload["tokens"])
        extras = tuple(sorted(k for k in payload if k not in ("tokens", "max_new_tokens")))
        family = self.cfg.family
        if "frames" in extras and family != "encdec":
            raise ValueError(f"{self.cfg.name}: payload key 'frames' belongs to the enc-dec "
                             f"family, not to the {family!r} family")
        if family == "vlm" and "vision" not in extras:
            raise ValueError(f"{self.cfg.name}: a vlm request requires vision embeddings")
        if family == "encdec" and "frames" not in extras:
            raise ValueError(f"{self.cfg.name}: an encdec request requires frames")
        if family in ("zamba", "xlstm"):
            from repro_torch.models.ssm import check_chunks

            check_chunks(toks.shape[-1], self.cfg)
        return (toks.shape[-1], int(payload["max_new_tokens"]), extras)

    def bucket(self, signature: Hashable, n_policy: bucketing.NBucketPolicy) -> Hashable:
        return signature  # prompts are not length-padded (no attention mask yet)

    def solve_bucket(
        self,
        bucket_sig: Hashable,
        payloads: List[Dict[str, Any]],
        keys: List[torch.Generator],
        batch_bucket: int,
    ) -> List[Any]:
        prompt_len, max_new, extras = bucket_sig
        lanes = [_prompt_rows(p) for p in payloads]
        counts = [x.shape[0] for x in lanes]
        total = sum(counts)
        if total < batch_bucket:
            lanes.append(torch.zeros((batch_bucket - total, prompt_len), dtype=torch.int32))
        batch_in = {"tokens": _gather(lanes, self.device, stack=False)}
        for name in extras:
            arrs = []
            for p in payloads:
                a = torch.as_tensor(p[name])
                arrs.append(a[None] if torch.as_tensor(p["tokens"]).dim() == 1 else a)
            if total < batch_bucket:
                arrs.append(arrs[0].new_zeros((batch_bucket - total, *arrs[0].shape[1:])))
            batch_in[name] = _gather(arrs, self.device, stack=False)
        out_tokens, self.last_timing = self._generate(self.params, batch_in, max_new)
        self.timings.append(self.last_timing)

        results = []
        offset = 0
        for p, c in zip(payloads, counts):
            rows = out_tokens[offset : offset + c]
            results.append(rows[0] if torch.as_tensor(p["tokens"]).dim() == 1 else rows)
            offset += c
        return results

    def cost_units(self, bucket_sig: Hashable, batch_bucket: int) -> float:
        prompt_len, max_new, _ = bucket_sig
        # prefill is O(L · d² · layers); each decode step O(d² · layers).
        per_tok = self.cfg.n_layers * self.cfg.d_model * self.cfg.d_model
        return float(batch_bucket) * (prompt_len + max_new) * per_tok

    def fpga_seconds(self, bucket_sig: Hashable) -> Optional[float]:
        return None  # no ONN mapping for the LM workload


register_solver("lm", LMEngineSolver, "greedy LM decode loop (prefill + serve steps)")
