"""Shared load generation for the serve daemon's CLI and checks (the port of
``repro.serving.load``).

One deterministic mixed request stream (two retrieval pattern sizes plus
max-cut instances, spread over tenants) and an open-loop Poisson arrival
schedule: arrival times are drawn once, up front, independent of service
progress — the load does not slow down when the server falls behind, which
is what makes sustained-throughput and tail-latency numbers honest.
"""

from __future__ import annotations

import time
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ising import random_graph
from repro_torch.data import patterns as pat
from repro_torch.engine.engine import SEED_BOUND, Request

#: Default tenant mix: id → fair-share weight (the CLI default).
DEFAULT_TENANTS: Tuple[Tuple[str, float], ...] = (("alpha", 2.0), ("beta", 1.0))


def install_mixed_workloads(
    engine: Any,
    *,
    sweeps: int = 8,
    replicas: int = 1,
    small_ckpt: Optional[str] = None,
) -> None:
    """Install the stream's three workloads on the engine's device:
    ``small`` retrieval (N=42), ``large`` retrieval (N=100), both trained
    with DO-I on their letter sets, and ``cuts`` max-cut.

    ``small_ckpt`` restores the ``small`` workload from an ONN checkpoint
    (:func:`repro_torch.checkpoint.onn.load_onn`) instead of training
    in-process — the daemon-restart path after a trained matrix was
    persisted.  The checkpoint must be N=42 (the stream's small probes).
    """
    dev = engine.device
    if small_ckpt is None:
        engine.install("small", "retrieval", xi=pat.load_dataset("7x6", device="cpu"),
                       device=dev)
    else:
        from repro_torch.engine.adapters import RetrievalEngineSolver

        engine.install(
            "small",
            RetrievalEngineSolver(solver=restore_retrieval(small_ckpt, n=42, device=dev)),
        )
    engine.install("large", "retrieval", xi=pat.load_dataset("10x10", device="cpu"),
                   device=dev)
    engine.install("cuts", "maxcut", sweeps=sweeps, replicas=replicas, device=dev)


def restore_retrieval(ckpt_path: str, n: Optional[int] = None, device=None) -> Any:
    """An ``api.RetrievalSolver`` restored from an ONN checkpoint onto
    ``device`` (the GPU unless ``"cpu"``)."""
    from repro_torch import api
    from repro_torch.checkpoint.onn import load_onn

    ck = load_onn(ckpt_path, device=device)
    if n is not None and ck.config.n != n:
        raise ValueError(f"checkpoint is N={ck.config.n}, the workload needs N={n}")
    return api.RetrievalSolver(config=ck.config, params=ck.params)


def mixed_requests(
    n_requests: int,
    seed: int = 0,
    tenants: Sequence[Tuple[str, float]] = DEFAULT_TENANTS,
    maxcut_every: int = 4,
) -> List[Request]:
    """A deterministic mixed stream with per-request generators pinned.

    Tenant, workload, pattern row, lane count and graph size come from
    ``np.random.default_rng(seed)`` in the reference's order, so they are the
    reference's for the same seed.  The payloads come from one CPU
    ``torch.Generator`` seeded with ``seed``, which draws two seeds per
    request: one for the payload (the corrupted pixels, or the graph) and
    one for ``Request.key``, a CPU generator, so the same stream served
    through any scheduling policy, on any device, returns the same result
    per request.
    """
    rng = np.random.default_rng(seed)
    xi_small = pat.load_dataset("7x6", device="cpu")
    xi_large = pat.load_dataset("10x10", device="cpu")
    names = [t for t, _ in tenants]
    weights = np.asarray([w for _, w in tenants], np.float64)
    weights = weights / weights.sum()
    root = torch.Generator().manual_seed(seed)
    out: List[Request] = []
    for i in range(n_requests):
        payload_seed, request_seed = (
            int(s) for s in torch.randint(SEED_BOUND, (2,), generator=root)
        )
        draw = torch.Generator().manual_seed(payload_seed)
        key = torch.Generator().manual_seed(request_seed)
        tenant = names[int(rng.choice(len(names), p=weights))]
        if maxcut_every and i % maxcut_every == maxcut_every - 1:
            adj = random_graph(draw, int(rng.integers(16, 40)), 0.5)
            out.append(Request("cuts", adj, key=key, tenant=tenant))
        else:
            xi = xi_small if i % maxcut_every == 0 else xi_large
            row = int(rng.integers(0, xi.shape[0]))
            lanes = int(rng.integers(1, 5))
            batch = pat.corrupt_batch(xi[row], 0.25, lanes, generator=draw)
            payload = batch[0] if lanes == 1 else batch
            out.append(Request("small" if i % maxcut_every == 0 else "large",
                               payload, key=key, tenant=tenant))
    return out


def poisson_offsets(n: int, rate_rps: float, seed: int = 0) -> List[float]:
    """Ascending arrival offsets (seconds) of an open-loop Poisson process."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    gaps = np.random.default_rng(seed + 1).exponential(1.0 / rate_rps, size=n)
    return list(np.cumsum(gaps))


def timed_source(
    requests: Sequence[Request],
    offsets: Sequence[float],
    clock: Any = time.perf_counter,
) -> Iterator[Optional[List[Request]]]:
    """Open-loop daemon source: each tick releases every request now due.

    The schedule is anchored at the first ``next()``; the generator closes
    once the last request is released (the daemon then drains).
    """
    if len(requests) != len(offsets):
        raise ValueError(f"{len(requests)} requests vs {len(offsets)} offsets")
    t_start = clock()
    i = 0
    while i < len(requests):
        now = clock() - t_start
        due: List[Request] = []
        while i < len(requests) and offsets[i] <= now:
            due.append(requests[i])
            i += 1
        yield due or None


def ticked_source(
    requests: Sequence[Request], per_tick: int = 1
) -> Iterator[List[Request]]:
    """Deterministic source: ``per_tick`` requests per daemon tick (tests,
    examples — no wall-clock dependence)."""
    if per_tick < 1:
        raise ValueError(f"per_tick must be >= 1, got {per_tick}")
    for i in range(0, len(requests), per_tick):
        yield list(requests[i : i + per_tick])
