"""The MoE parity rule: how two implementations of one MoE LM are held to
each other when a router's top-k may flip at a near-tie.

A MoE block routes each token to the k experts of largest router
probability.  The router logits ℓ = x · R are float32 sums over the model
width D, and the two sides' router inputs x differ (by ulps in float32, by
bf16 roundings in bfloat16).  Where two logits lie closer than those
differences allow, the two sides may route the token differently, and a
token routed to another expert moves its hidden state, and through
attention every later position of its sequence, by far more than the LM
rule's τ (``tests/lm_rule.py``).

**δ.**  Side b is the reference (``repro``, or the CPU copy of a card
model), side a the port (or the card).  Each side's float32 router logits
ℓ_a, ℓ_b are recorded at every MoE call, as that side computed them (the
float32 product of its own router input; TF32 off on the card).  They
differ by what the two sides' inputs and float32 summation orders make of
them: at most d = max_e |ℓ_a,e − ℓ_b,e| for the token.  (A bound from the
inputs alone, Σ_d |Δx_d| |R_de| + γ_D Σ_d |x_d| |R_de| with γ_D = D·2⁻²⁴ /
(1 − D·2⁻²⁴), is about 40 times looser at D = 1536 and would call a third
of a full-width float32 run's routings tie-bound.)  The softmax and top-k
act on probabilities: exp(ℓ_e − m) / Z keeps the order of two logits whose
float32 gap exceeds s = 2⁻²⁴ · (8 + 2 · spread), spread = max_e ℓ − min_e ℓ
(the subtraction of m, exp and the division each round by a few 2⁻²⁴).
δ = d + s / 2: a gap of more than 2δ in ℓ_b is a gap of more than s on both
sides, so both order the two experts as ℓ_b does.

**Decided.**  A token's routing is *decided* when the gap between its k-th
and (k+1)-th largest ℓ_b exceeds 2δ: both sides then choose the same set of
experts, the *ideal* one.  Otherwise it is *tie-bound*.  Within a decided
set two experts may lie closer than 2δ, so the order of a token's k slots
is compared as a set: a token's k experts are distinct, so a pair's
capacity rank counts the earlier tokens of its sequence that chose its
expert, whatever the slot order, and the slot order moves only the order of
the output's k-term sum.  Where every token of a sequence up to and
including this one is decided (the sequence's *exact prefix*), each
(token, expert) pair's capacity rank and kept flag equal the ideal's too.

**The rule** (:func:`hold_calls`, :func:`hold`):

* on every decided token, each side's set of experts equals the ideal's
  (``==``); on the exact prefix, each pair's capacity rank and ``keep``
  too;
* on every tie-bound token, each side's chosen experts are a top-k of ℓ_b
  within 2δ: the least ℓ_b chosen is at least the largest ℓ_b not chosen
  minus 2δ;
* where every routing of a run is decided, the LM rule holds as it is;
* otherwise the LM rule holds at every step of a row whose position (step
  t reads position prompt_len − 1 + t) precedes the row's first tie-bound
  routing in any layer; the summary reports the tie-bound routings and the
  steps held.

Fixed before any comparison; a routing that breaks it is a port fault
(ROADMAP.md, section 3), recorded with its inputs.  Used by
``tests/test_torch_lm_families.py`` (port against ``repro``),
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (card against CPU);
imports numpy and torch only (and the port's ``models.layers`` when it
records).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from lm_rule import hold as lm_hold

#: Unit roundoff of float32.
U32 = 2.0**-24


@dataclasses.dataclass(eq=False)
class Call:
    """One MoE call seen from both sides: each side's float32 router logits
    (B, S, E), each side's own routing (``idx`` (B, S, k), ``pos`` and
    ``keep`` (B, S·k)) where it was recorded, the call's top-k and capacity,
    and the sequence position of token 0 (0 for a prefill, the cache index
    for a decode step)."""

    logits_a: np.ndarray
    logits_b: np.ndarray
    k: int
    capacity: int
    first_position: int = 0
    routing_a: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    routing_b: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None


def delta(logits_a: np.ndarray, logits_b: np.ndarray) -> np.ndarray:
    """(B, S) δ of each token (see the module docstring)."""
    a = np.asarray(logits_a, np.float64)
    b = np.asarray(logits_b, np.float64)
    spread = b.max(axis=-1) - b.min(axis=-1)
    return np.abs(a - b).max(axis=-1) + 0.5 * U32 * (8.0 + 2.0 * spread)


def ideal(ell: np.ndarray, k: int, capacity: int):
    """The routing that logits ``ell`` (B, S, E) give: (idx (B, S, k) in
    descending order, the lower expert first on ties; pos, keep (B, S·k))."""
    b, s, e = ell.shape
    idx = np.argsort(-ell, axis=-1, kind="stable")[..., :k]
    flat = idx.reshape(b, s * k)
    onehot = flat[..., None] == np.arange(e)
    pos = np.take_along_axis(np.cumsum(onehot, axis=1) - 1, flat[..., None], axis=-1)[..., 0]
    return idx, pos, pos < capacity


def rank_table(idx: np.ndarray, pos: np.ndarray, keep: np.ndarray, n_experts: int):
    """(B, S, E) capacity rank of each (token, expert) pair (−1 where the
    token did not choose the expert) and its kept flag, whatever the order
    of the token's k slots."""
    b, s, k = idx.shape
    rank = np.full((b, s, n_experts), -1, np.int64)
    kept = np.zeros((b, s, n_experts), bool)
    np.put_along_axis(rank, idx.astype(np.int64), np.asarray(pos).reshape(b, s, k), axis=-1)
    np.put_along_axis(kept, idx.astype(np.int64), np.asarray(keep).reshape(b, s, k), axis=-1)
    return rank, kept


def boundary_gap(ell: np.ndarray, k: int) -> np.ndarray:
    """(B, S): the gap between the k-th and (k+1)-th largest of ``ell``."""
    top = -np.sort(-ell, axis=-1)[..., : k + 1]
    return top[..., k - 1] - top[..., k]


def decided(ell: np.ndarray, dlt: np.ndarray, k: int) -> np.ndarray:
    """(B, S): the k-th and (k+1)-th largest of ``ell`` lie more than 2δ
    apart."""
    return boundary_gap(ell, k) > 2.0 * dlt


def hold_calls(calls: Sequence[Call], what: str = "") -> Dict[str, Any]:
    """Apply the routing half of the rule to every call; raises
    ``AssertionError`` naming the first miss.  Returns ``first_tie`` (B,),
    each row's first tie-bound position (a large number where none), the
    tie-bound routings, the routings and the least ratio of a decided
    token's boundary gap to 2δ."""
    b = calls[0].logits_b.shape[0]
    first_tie = np.full(b, np.iinfo(np.int64).max)
    n_tie = n_all = 0
    least = np.inf
    for c_i, c in enumerate(calls):
        ell = np.asarray(c.logits_b, np.float64)
        dlt = delta(c.logits_a, c.logits_b)
        ok = decided(ell, dlt, c.k)
        idx, pos, keep = ideal(ell, c.k, c.capacity)
        rank, kept = rank_table(idx, pos, keep, ell.shape[-1])
        prefix = np.cumprod(ok, axis=1).astype(bool)  # the exact prefix
        n_tie += int((~ok).sum())
        n_all += ok.size
        if ok.any():
            least = min(least, float((boundary_gap(ell, c.k) / (2.0 * dlt))[ok].min()))
        for row in range(b):
            ties = np.flatnonzero(~ok[row])
            if ties.size:
                first_tie[row] = min(first_tie[row], c.first_position + int(ties[0]))
        for side, routing in (("a", c.routing_a), ("b", c.routing_b)):
            if routing is None:
                continue
            s_idx, s_pos, s_keep = (np.asarray(v) for v in routing)
            where = f"{what}: call {c_i}, side {side}"
            same = np.all(np.sort(s_idx, axis=-1) == np.sort(idx, axis=-1), axis=-1)
            if not np.all(same[ok]):
                bad = tuple(int(i) for i in np.argwhere(ok & ~same)[0])
                raise AssertionError(f"{where}: decided routing differs at (row, token) {bad}: "
                                     f"{s_idx[bad]} against {idx[bad]}")
            s_rank, s_kept = rank_table(s_idx, s_pos, s_keep, ell.shape[-1])
            if not (np.array_equal(s_rank[prefix], rank[prefix])
                    and np.array_equal(s_kept[prefix], kept[prefix])):
                raise AssertionError(f"{where}: capacity ranks differ on the exact prefix")
            chosen = np.take_along_axis(ell, s_idx.astype(np.int64), axis=-1)
            mask = np.ones(ell.shape, bool)
            np.put_along_axis(mask, s_idx.astype(np.int64), False, axis=-1)
            other = np.where(mask, ell, -np.inf).max(axis=-1)
            if not np.all(chosen.min(axis=-1) >= other - 2.0 * dlt):
                bad = np.argwhere(chosen.min(axis=-1) < other - 2.0 * dlt)[0]
                raise AssertionError(f"{where}: experts at (row, token) "
                                     f"{tuple(int(i) for i in bad)} are not a top-k within 2δ")
    return {"first_tie": first_tie, "route_bound": n_tie, "routings": n_all,
            "least_decided_gap_over_2delta": least}


def hold(tokens, port_logits, ref_logits, dtype: str, n_layers: int, calls: Sequence[Call],
         prompt_len: int, what: str = "") -> Dict[str, Any]:
    """The whole rule on a teacher-forced stream (``tokens`` (B, T), both
    sides' (B, T, V) logits, as ``lm_rule.hold`` takes them) and its MoE
    calls in both sides' run order.  Returns the LM rule's summary over the
    steps held (None when none is), with ``route_bound``, ``routings``,
    ``steps_held`` and ``steps``."""
    routes = hold_calls(calls, what)
    tokens = np.asarray(tokens)
    b, t = tokens.shape
    # Step j reads position prompt_len − 1 + j; it is held before the row's first tie.
    held = np.clip(routes["first_tie"] - (prompt_len - 1), 0, t).astype(int)
    summary: Optional[Dict[str, Any]] = None
    if np.all(held == t):
        summary = lm_hold(tokens, port_logits, ref_logits, dtype, n_layers, what)
    else:
        parts = [lm_hold(tokens[r : r + 1, : held[r]], np.asarray(port_logits)[r : r + 1, : held[r]],
                         np.asarray(ref_logits)[r : r + 1, : held[r]], dtype, n_layers,
                         f"{what} row {r}")
                 for r in range(b) if held[r]]
        if parts:
            summary = {
                "dtype": dtype,
                "max_diff_over_tau": max(p["max_diff_over_tau"] for p in parts),
                "max_abs_diff": max(p["max_abs_diff"] for p in parts),
                "steps_decided": sum(p["steps_decided"] for p in parts),
                "tokens_not_ref_argmax": sum(p["tokens_not_ref_argmax"] for p in parts),
            }
    return {**(summary or {"dtype": dtype, "max_diff_over_tau": None}),
            "route_bound": routes["route_bound"], "routings": routes["routings"],
            "least_decided_gap_over_2delta": routes["least_decided_gap_over_2delta"],
            "steps_held": int(held.sum()), "steps": b * t}


@contextlib.contextmanager
def recording():
    """Within the block, every call of the port's ``models.layers.moe_ffn``
    appends to the yielded list its router logits and routing (``logits``,
    ``idx``, ``pos``, ``keep`` from ``moe_route`` on the same device, as
    ``moe_ffn`` computes them), copied to the CPU as numpy."""
    from repro_torch.models import layers as L

    calls: List[Dict[str, Any]] = []
    original = L.moe_ffn

    def recorded(params, x, cfg):
        r = L.moe_route(params["router"], x, cfg)
        calls.append({
            "logits": r.logits.cpu().numpy(), "idx": r.idx.cpu().numpy(),
            "pos": r.pos.cpu().numpy(), "keep": r.keep.cpu().numpy(), "k": cfg.top_k,
            "capacity": r.capacity,
        })
        return original(params, x, cfg)

    L.moe_ffn = recorded
    try:
        yield calls
    finally:
        L.moe_ffn = original


def pair_calls(side_a: Sequence[Dict[str, Any]], side_b: Sequence[Dict[str, Any]],
               positions: Sequence[int]) -> List[Call]:
    """:class:`Call` s from the records of one teacher-forced run on each
    side (side a's from :func:`recording`; side b's need only ``logits``,
    and their routing is kept where they carry ``idx``, ``pos`` and
    ``keep``), ``positions`` giving each call's first sequence position."""
    if not (len(side_a) == len(side_b) == len(positions)):
        raise AssertionError(f"calls differ: {len(side_a)}, {len(side_b)}, {len(positions)}")
    return [Call(logits_a=a["logits"], logits_b=b["logits"], k=a["k"], capacity=a["capacity"],
                 first_position=p, routing_a=(a["idx"], a["pos"], a["keep"]),
                 routing_b=(b["idx"], b["pos"], b["keep"]) if "idx" in b else None)
            for a, b, p in zip(side_a, side_b, positions)]


def stream_positions(n_moe_layers: int, prompt_len: int, steps: int) -> List[int]:
    """Each MoE call's first position in a teacher-forced run (``lm_rule.
    stream_logits``'s order): the prefill's layers at 0, then each decode
    step's layers at its cache index."""
    out = [0] * n_moe_layers
    for t in range(1, steps):
        out += [prompt_len + t - 1] * n_moe_layers
    return out


def hold_streams(model, params_a, params_b, prompts, stream, vision=None, frames=None,
                 what: str = "") -> Dict[str, Any]:
    """Two port models on the same weights (the card's ``params_a``, the
    CPU's ``params_b``) teacher-forced on ``stream`` (``lm_rule.
    stream_logits``), their MoE calls recorded: held by this rule for a MoE,
    by the LM rule at ``lm_rule.depth`` otherwise.  Returns the rule's
    summary."""
    from lm_rule import depth, stream_logits

    with recording() as calls_a:
        logits_a = stream_logits(model, params_a, prompts, stream, vision=vision, frames=frames)
    with recording() as calls_b:
        logits_b = stream_logits(model, params_b, prompts, stream, vision=vision, frames=frames)
    cfg = model.cfg
    if cfg.family != "moe":
        return lm_hold(stream, logits_a, logits_b, cfg.dtype, depth(cfg), what)
    length, steps = np.shape(prompts)[1], np.shape(stream)[1]
    calls = pair_calls(calls_a, calls_b, stream_positions(cfg.n_layers, length, steps))
    return hold(stream, logits_a, logits_b, cfg.dtype, cfg.n_layers, calls, length, what)
