"""Max-Cut on the ONN, an oscillatory Ising machine: the port of
``repro.core.ising``.

For a graph with adjacency A, the couplings J = −A (quantized to
``weight_bits``) make the Ising ground state the maximum cut.  Two solvers:

* :func:`solve_maxcut_batch` — the batched annealer.  Each instance holds a
  (replicas, N) spin state; every sweep partitions the true vertices into K
  update groups by a fresh random priority order, and the groups fire in
  turn, each evaluating its members' fields through :func:`weighted_sum` on
  ``cfg.backend`` (one launch for all instances on the kernel routes) and
  sign-updating exactly those members.  Replicas freeze after
  ``stagnation`` sweeps without a better cut, checked every
  ``cfg.settle_chunk`` sweeps: the host synchronises once per chunk.
* :func:`solve_maxcut` — the sequential oracle: every sweep visits each
  vertex once through :func:`~repro_torch.core.dynamics.async_sweep`.

The port draws no random numbers inside either solver.  Randomness enters
as tensors: the initial uniforms (σ₀ = −1 where u < 0.5, else +1) and one
row of priorities per sweep for the batched solver, the initial spins and
one visiting order per sweep for the oracle.  The reference draws them from
counter-based JAX keys, so a padded vertex never changes the draws of the
real ones; here the caller's uniforms carry the same property, and padded
vertices (index ≥ ``true_n``) get priority +inf and are masked out of every
group, so a bucket-padded solve equals the unpadded one on the real
vertices.  ``repro_torch.api.MaxCutSolver`` draws the uniforms from a
``torch.Generator``.

With integer edge weights every ``MaxCutResult`` field is bit-exact with the
reference under the same draws: the priority sort is stable, the best
replica is the first maximum, and cut values are sums of integers below
2**24 (see :func:`cut_value_exact`).  With other weights the cut values are
float32 sums in another order than the reference's, within the bound that
:func:`cut_value_exact` states.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from repro_torch.core.dynamics import ONNConfig, async_sweep, sign_update, weighted_sum
from repro_torch.core.quantization import QuantizedWeights, quantize_weights

#: Update-group count K when ``stagger_groups`` is 0 (the reference's value).
DEFAULT_STAGGER_GROUPS = 16


class MaxCutResult(NamedTuple):
    """Outcome of a max-cut anneal (batched: a leading instance dimension).

    ``sigma``/``cut_value`` are the best assignment seen across all sweeps
    and replicas; ``trace`` is the best-so-far cut after each sweep (entries
    past ``sweeps_run`` repeat the final best).  The oracle leaves
    ``replica_cuts`` and ``sweeps_run`` None.
    """

    sigma: torch.Tensor  # (..., N) int8 best spin assignment
    cut_value: torch.Tensor  # (...,) float32 cut size
    trace: torch.Tensor  # (..., sweeps) float32 best cut after each sweep
    replica_cuts: Optional[torch.Tensor] = None  # (..., replicas) best cut per replica
    sweeps_run: Optional[torch.Tensor] = None  # (...,) int32 sweeps executed


class _AnnealCarry(NamedTuple):
    """State of the batched annealer; every field leads with the instance axis."""

    sigma: torch.Tensor  # (I, R, N) current spins
    best_sigma: torch.Tensor  # (I, R, N) best spins per replica
    best_cut: torch.Tensor  # (I, R) best cut per replica
    since_improve: torch.Tensor  # (I, R) int32 sweeps since a replica improved
    frozen: torch.Tensor  # (I, R) replica stopped on cut stagnation
    trace: torch.Tensor  # (I, sweeps) best-so-far cut across replicas
    ran: torch.Tensor  # (I,) int32 sweeps executed while a replica ran
    t: torch.Tensor  # (I,) int32 sweep clock (overruns `ran` within a chunk)


@contextlib.contextmanager
def _full_fp32_matmul():
    """Float32 matrix products in full float32 (no TF32) inside the block.

    The cut products below are exact only if every partial sum is; TF32
    would round ±1 and 0/1 operands exactly too, but the exactness argument
    is made for float32 and does not lean on that.
    """
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def maxcut_couplings(adjacency: torch.Tensor, weight_bits: int = 5) -> QuantizedWeights:
    """Quantized ONN couplings for max-cut: J = −A (antiferromagnetic)."""
    return quantize_weights(-adjacency.to(torch.float32), bits=weight_bits)


def cut_value_exact(adjacency: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Weighted cut size Σ_{i<j} A_ij (1 − σ_i σ_j) / 2 in float32;
    ``adjacency`` (N, N), ``sigma`` (..., N).

    0.5 · (total − σ A_triu σ), as the reference computes it.  Exact for
    integer weights only: when their total is below 2**24 — every 0/1 graph
    up to N = 5,793, and at N = 506 at most N(N−1)/2 = 127,765 edges — every
    partial sum is an integer below 2**24, so the float32 result is exact in
    any order.  For other weights the sums round, in torch's order here and
    in XLA's einsum order in the reference: each result is within
    (γ_E + 2⁻²⁴) · Σ_{i<j} |A_ij| of the exact cut, E the number of nonzero
    A_ij (i < j) and γ_E = E·2⁻²⁴ / (1 − E·2⁻²⁴), so the two packages differ
    by at most twice that.
    """
    a = torch.triu(adjacency.to(torch.float32), diagonal=1)
    return 0.5 * (a.sum() - _pair_sums(sigma.to(torch.float32), a))


def _pair_sums(sig: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """σ A σ for float32 spins (..., N) and (..., N, N) upper-triangular A."""
    with _full_fp32_matmul():
        return (torch.matmul(sig, a) * sig).sum(-1)


def resolve_stagger_groups(stagger_groups: int, n: int) -> int:
    """The effective update-group count K for an N-vertex solve: 0 resolves
    to ``min(DEFAULT_STAGGER_GROUPS, n)``; explicit values clamp to [1, n]."""
    if stagger_groups < 0:
        raise ValueError(f"stagger_groups must be >= 0, got {stagger_groups}")
    k = stagger_groups if stagger_groups > 0 else DEFAULT_STAGGER_GROUPS
    return max(1, min(k, n))


def _sweep(
    cfg: ONNConfig,
    weights: torch.Tensor,
    sigma: torch.Tensor,
    uniforms: torch.Tensor,
    groups: int,
    true_n: torch.Tensor,
    blocked: torch.Tensor,
) -> torch.Tensor:
    """One grouped sweep of every instance: ``weights`` (I, N, N) int8,
    ``sigma`` (I, R, N), ``uniforms`` (I, N), ``true_n`` (I,), ``blocked``
    (I, R) replicas that must not change."""
    inst, replicas, n = sigma.shape
    dev = sigma.device
    idx = torch.arange(n, device=dev)
    pri = torch.where(idx[None, :] < true_n[:, None], uniforms.to(torch.float32), torch.inf)
    order = torch.argsort(pri, dim=-1, stable=True)  # rank → vertex; padded last
    group_size = torch.clamp((true_n + groups - 1) // groups, min=1)
    # A window of ceil(n / K) ranks covers any true group; its start is
    # clipped to stay in bounds and ranks outside the group are masked, so a
    # padded solve replays the unpadded one.  A window is a slice of a
    # permutation: its members are distinct, so the scatter's order is moot.
    window = -(-n // groups)
    span = torch.arange(window, device=dev)
    rows = torch.arange(inst, device=dev)[:, None]
    for g in range(groups):
        start = torch.clamp(g * group_size, 0, n - window)
        ranks = start[:, None] + span[None, :]  # (I, window)
        members = torch.gather(order, 1, ranks)
        field = weighted_sum(cfg, weights[rows, members], sigma)  # (I, R, window)
        at = members[:, None, :].expand(inst, replicas, window)
        cur = torch.gather(sigma, 2, at)
        mine = (ranks // group_size[:, None] == g) & (ranks < true_n[:, None])
        upd = mine[:, None, :] & ~blocked[:, :, None]
        sigma = sigma.scatter(2, at, torch.where(upd, sign_update(field, cur), cur))
    return sigma


def staggered_sweep(
    cfg: ONNConfig,
    weights: torch.Tensor,
    sigma: torch.Tensor,
    uniforms: torch.Tensor,
    *,
    groups: int,
    true_n=None,
    frozen: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One grouped-staggered-enable sweep of (replicas, N) spin states.

    The true vertices, ranked by ``uniforms`` (N,) (a stable sort; padded
    vertices last), form ``groups`` contiguous rank groups of
    ceil(true_n / groups); the groups fire in turn, each evaluating
    W[members] σ through ``cfg.backend`` against the state the previous
    group left and sign-updating its members.  ``groups == N`` is the
    asynchronous Hopfield sweep.  ``frozen`` (replicas,) replicas stay put.

    Batched: ``weights`` (I, N, N), ``sigma`` (I, R, N), ``uniforms``
    (I, N), ``true_n`` (I,), ``frozen`` (I, R).
    """
    single = weights.dim() == 2
    if single:
        weights, sigma, uniforms = weights[None], sigma[None], uniforms[None]
        frozen = None if frozen is None else frozen[None]
    inst, replicas, n = sigma.shape
    tn = _true_n(true_n, inst, n, sigma.device)
    blocked = (torch.zeros((inst, replicas), dtype=torch.bool, device=sigma.device)
               if frozen is None else frozen)
    out = _sweep(cfg, weights, sigma, uniforms, groups, tn, blocked)
    return out[0] if single else out


def _true_n(true_n, inst: int, n: int, device) -> torch.Tensor:
    if true_n is None:
        return torch.full((inst,), n, dtype=torch.int64, device=device)
    tn = torch.as_tensor(true_n, device=device).to(torch.int64)
    return tn.expand(inst) if tn.dim() == 0 else tn


def _cuts(total: torch.Tensor, a_tri: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """(I, R) cut values of spins (I, R, N): the reference's
    0.5 · (total − σ A_triu σ), exact as :func:`cut_value_exact` states."""
    return 0.5 * (total[:, None] - _pair_sums(sigma.to(torch.float32), a_tri))


def _anneal_step(cfg, w, a_tri, total, u_sweeps, true_n, groups, stagnation, c):
    """One sweep of every instance, the reference's ``anneal_step``."""
    sweeps = cfg.max_cycles
    rows = torch.arange(c.t.shape[0], device=c.t.device)
    active = c.t < sweeps
    running = active & ~torch.all(c.frozen, dim=-1)
    # A step at t >= sweeps blocks every replica, so its uniforms are moot.
    u = u_sweeps[rows, torch.clamp(c.t, max=sweeps - 1).to(torch.int64)]
    sigma = _sweep(cfg, w, c.sigma, u, groups, true_n, c.frozen | ~active[:, None])
    cut = _cuts(total, a_tri, sigma)
    improved = active[:, None] & ~c.frozen & (cut > c.best_cut)
    best_sigma = torch.where(improved[:, :, None], sigma, c.best_sigma)
    best_cut = torch.maximum(cut, c.best_cut)
    since = torch.where(improved, 0, c.since_improve + active[:, None].to(torch.int32))
    frozen = c.frozen | (active[:, None] & (since >= stagnation)) if stagnation > 0 else c.frozen
    # The trace takes max(best_cut) at column t while t < sweeps (an overrun
    # step writes the column's own value back).
    col = torch.clamp(c.t, max=sweeps - 1)[:, None].to(torch.int64)
    val = torch.where(active[:, None], best_cut.max(dim=-1, keepdim=True).values,
                      torch.gather(c.trace, 1, col))
    return _AnnealCarry(
        sigma=sigma,
        best_sigma=best_sigma,
        best_cut=best_cut,
        since_improve=since.to(torch.int32),
        frozen=frozen,
        trace=c.trace.scatter(1, col, val),
        ran=c.ran + running.to(torch.int32),
        t=c.t + 1,
    )


def solve_maxcut_batch(
    cfg: ONNConfig,
    adjacency: torch.Tensor,
    init_uniforms: torch.Tensor,
    sweep_uniforms: torch.Tensor,
    *,
    stagger_groups: int = 0,
    stagnation: int = 0,
    true_n=None,
) -> MaxCutResult:
    """Anneal a batch of max-cut instances on the batched ONN core.

    ``adjacency`` (I, N, N), or (N, N) for one instance (an unbatched result).
    ``init_uniforms`` (I, R, N) float32: replica r of instance i starts at
    σ = −1 where u < 0.5, else +1 (R = the replica count).
    ``sweep_uniforms`` (I, ``cfg.max_cycles``, N) float32: sweep t ranks the
    vertices of instance i by ``sweep_uniforms[i, t]``.  For one instance
    both drop their leading axis.  The uniforms move to the adjacency's
    device; the solve runs there.

    Each sweep is :func:`staggered_sweep` with K = ``stagger_groups`` groups
    (0 → ``min(DEFAULT_STAGGER_GROUPS, N)``), every field through
    ``cfg.backend``.  ``stagnation`` > 0 freezes a replica after that many
    sweeps without a better cut; every ``cfg.settle_chunk`` sweeps (0 → all
    of them) the host checks once whether any instance still runs, and an
    instance whose replicas are all frozen keeps its state from then on.
    ``true_n`` (I,) (or a scalar) marks padded instances: vertices past it
    are never updated.
    """
    adjacency = torch.as_tensor(adjacency)
    dev = adjacency.device
    init_uniforms = torch.as_tensor(init_uniforms).to(device=dev, dtype=torch.float32)
    sweep_uniforms = torch.as_tensor(sweep_uniforms).to(device=dev, dtype=torch.float32)
    single = adjacency.dim() == 2
    if single:
        adjacency, init_uniforms, sweep_uniforms = (
            adjacency[None], init_uniforms[None], sweep_uniforms[None])
    n, sweeps = cfg.n, cfg.max_cycles
    if adjacency.dim() != 3 or tuple(adjacency.shape[-2:]) != (n, n):
        raise ValueError(f"adjacency {tuple(adjacency.shape)} != (I, {n}, {n})")
    inst = adjacency.shape[0]
    if init_uniforms.dim() != 3 or init_uniforms.shape[0] != inst or init_uniforms.shape[2] != n:
        raise ValueError(f"init_uniforms {tuple(init_uniforms.shape)} != (I={inst}, R, {n})")
    replicas = init_uniforms.shape[1]
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if tuple(sweep_uniforms.shape) != (inst, sweeps, n):
        raise ValueError(
            f"sweep_uniforms {tuple(sweep_uniforms.shape)} != ({inst}, {sweeps}, {n})")
    if stagnation < 0:
        raise ValueError(f"stagnation must be >= 0, got {stagnation}")
    groups = resolve_stagger_groups(stagger_groups, n)
    tn = _true_n(true_n, inst, n, dev)

    w = torch.stack([maxcut_couplings(a, cfg.weight_bits).values for a in adjacency])
    a_tri = torch.triu(adjacency.to(torch.float32), diagonal=1)
    total = a_tri.sum(dim=(-2, -1))
    sigma0 = torch.where(init_uniforms < 0.5, -1, 1).to(torch.int8)
    carry = _AnnealCarry(
        sigma=sigma0,
        best_sigma=sigma0,
        best_cut=_cuts(total, a_tri, sigma0),
        since_improve=torch.zeros((inst, replicas), dtype=torch.int32, device=dev),
        frozen=torch.zeros((inst, replicas), dtype=torch.bool, device=dev),
        trace=torch.zeros((inst, sweeps), dtype=torch.float32, device=dev),
        ran=torch.zeros((inst,), dtype=torch.int32, device=dev),
        t=torch.zeros((inst,), dtype=torch.int32, device=dev),
    )
    chunk = cfg.settle_chunk if cfg.settle_chunk > 0 else sweeps
    chunk = max(1, min(chunk, sweeps))
    while True:
        # The reference's while_loop condition, per instance; under its vmap an
        # instance whose condition is false keeps its carry while the others step.
        go = (carry.t < sweeps) & ~torch.all(carry.frozen, dim=-1)
        if not bool(go.any()):  # the one host synchronisation per chunk
            break
        nxt = carry
        for _ in range(chunk):
            nxt = _anneal_step(cfg, w, a_tri, total, sweep_uniforms, tn, groups, stagnation, nxt)
        carry = _AnnealCarry(*(
            torch.where(go.view(-1, *([1] * (old.dim() - 1))), new, old)
            for old, new in zip(carry, nxt)
        ))

    rows = torch.arange(inst, device=dev)
    best_overall = carry.best_cut.max(dim=-1).values
    steps = torch.arange(sweeps, device=dev)
    trace = torch.where(steps[None, :] < carry.ran[:, None], carry.trace, best_overall[:, None])
    best_r = torch.argmax(carry.best_cut, dim=-1)  # the first maximum, as jnp.argmax
    res = MaxCutResult(
        sigma=carry.best_sigma[rows, best_r],
        cut_value=carry.best_cut[rows, best_r],
        trace=trace,
        replica_cuts=carry.best_cut,
        sweeps_run=carry.ran,
    )
    if single:
        res = MaxCutResult(*(x[0] for x in res))
    return res


def solve_maxcut(
    adjacency: torch.Tensor,
    sigma0: torch.Tensor,
    orders: torch.Tensor,
    weight_bits: int = 5,
) -> MaxCutResult:
    """Sequential-sweep oracle: sweep t visits every vertex once in the order
    ``orders[t]`` through :func:`async_sweep`, from the initial spins
    ``sigma0`` (N,).  ``orders`` (sweeps, N) vertex indices.  Serial per
    vertex: a small-N reference, not a solver to scale.
    """
    w = maxcut_couplings(adjacency, weight_bits).values
    sigma = torch.as_tensor(sigma0, device=adjacency.device).to(torch.int8)
    best_sigma, best_cut = sigma, cut_value_exact(adjacency, sigma)
    trace = []
    for order in torch.as_tensor(orders):
        sigma = async_sweep(w, sigma, order)
        cut = cut_value_exact(adjacency, sigma)
        best_sigma = torch.where(cut > best_cut, sigma, best_sigma)
        best_cut = torch.maximum(cut, best_cut)
        trace.append(best_cut)
    trace = (torch.stack(trace) if trace
             else torch.zeros((0,), dtype=torch.float32, device=adjacency.device))
    return MaxCutResult(sigma=best_sigma, cut_value=best_cut, trace=trace)


def random_graph(generator: torch.Generator, n: int, p: float = 0.5) -> torch.Tensor:
    """Erdős–Rényi adjacency (symmetric, zero diagonal, 0/1 int8) drawn from
    ``generator``, on its device.  Not the reference's bits for the same
    seed: tests build graphs with numpy or with the reference's function."""
    upper = torch.rand((n, n), generator=generator, device=generator.device) < p
    upper = torch.triu(upper, diagonal=1).to(torch.int8)
    return upper + upper.T
