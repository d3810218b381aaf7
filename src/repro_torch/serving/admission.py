"""Per-tenant fair queues for the continuous-batching scheduler (a copy of
``repro.serving.admission``, whose package ``__init__`` imports JAX).

Start-time fair queuing over *lanes* (the engine's unit of device work):
each tenant carries a virtual time that advances by ``lanes / weight``
whenever one of its requests is scheduled, and the scheduler always serves
the backlogged tenant with the smallest virtual time whose head-of-line
request fits the available slots.  Over any busy interval each tenant's
served lane share converges to its weight share — a tenant flooding the
queue only delays itself.

Queues are FIFO *within* a (tenant, bucket) pair, so two requests from one
tenant at one shape bucket never reorder; fairness decides only which
tenant goes next.  A tenant returning from idle has its virtual time
floored to the minimum over backlogged tenants, so idleness banks no
credit (the standard start-time fair queuing rule).
"""

from __future__ import annotations

import collections
from typing import Any, Deque, Dict, Hashable, List, Optional, Tuple

#: One queued unit: (item, lanes).  ``item`` is opaque to the queue (the
#: scheduler enqueues its ``_Pending`` records).
_Entry = Tuple[Any, int]


class FairQueues:
    """Weighted start-time fair queues keyed by (tenant, bucket signature).

    ``weights`` maps tenant id → relative share (default 1.0 for unknown
    tenants).  All operations are O(backlogged tenants) — fine for the
    handful of tenants a single-host daemon serves.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None):
        self._weights = dict(weights or {})
        for t, w in self._weights.items():
            if w <= 0:
                raise ValueError(f"tenant {t!r} weight must be > 0, got {w}")
        self._virtual: Dict[str, float] = {}
        self._queues: Dict[Tuple[str, Hashable], Deque[_Entry]] = {}

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    # -- enqueue -----------------------------------------------------------

    def push(self, tenant: str, qkey: Hashable, item: Any, lanes: int) -> None:
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if tenant not in self._virtual or not self._tenant_backlogged(tenant):
            # Returning from idle: floor to the backlogged minimum so idle
            # time banks no credit.
            floor = min(
                (self._virtual[t] for t in self._backlogged_tenants()),
                default=self._virtual.get(tenant, 0.0),
            )
            self._virtual[tenant] = max(self._virtual.get(tenant, 0.0), floor)
        self._queues.setdefault((tenant, qkey), collections.deque()).append(
            (item, lanes)
        )

    # -- dequeue -----------------------------------------------------------

    def pop(
        self, qkey: Hashable, max_lanes: Optional[int] = None
    ) -> Optional[Tuple[str, Any, int]]:
        """Serve the fairest fitting head-of-line request at ``qkey``.

        Returns ``(tenant, item, lanes)``, or None when no backlogged
        tenant's head request at this bucket fits in ``max_lanes``.
        Head-of-line only: a tenant whose head does not fit waits (its FIFO
        never reorders), but other tenants may still be served.
        """
        best: Optional[str] = None
        for (tenant, k), q in self._queues.items():
            if k != qkey or not q:
                continue
            if max_lanes is not None and q[0][1] > max_lanes:
                continue
            if best is None or (
                self._virtual.get(tenant, 0.0),
                tenant,  # deterministic tie-break
            ) < (self._virtual.get(best, 0.0), best):
                best = tenant
        if best is None:
            return None
        item, lanes = self._queues[(best, qkey)].popleft()
        self._virtual[best] = self._virtual.get(best, 0.0) + lanes / self.weight(best)
        return best, item, lanes

    def pop_all(self, qkey: Hashable) -> List[Tuple[str, Any, int]]:
        """Drain every request at ``qkey`` in fairness order (blocking
        workloads are packed into slabs downstream)."""
        out: List[Tuple[str, Any, int]] = []
        while True:
            nxt = self.pop(qkey)
            if nxt is None:
                return out
            out.append(nxt)

    def drain_items(self) -> List[Any]:
        """Remove and return every queued item (fairness order per bucket)."""
        out: List[Any] = []
        for qkey in self.qkeys():
            out.extend(item for _, item, _ in self.pop_all(qkey))
        return out

    # -- introspection -----------------------------------------------------

    def _tenant_backlogged(self, tenant: str) -> bool:
        return any(t == tenant and q for (t, _), q in self._queues.items())

    def _backlogged_tenants(self) -> List[str]:
        return sorted({t for (t, _), q in self._queues.items() if q})

    def qkeys(self) -> List[Hashable]:
        """Bucket signatures with queued work (insertion-ordered, deduped)."""
        seen: Dict[Hashable, None] = {}
        for (_, k), q in self._queues.items():
            if q:
                seen.setdefault(k, None)
        return list(seen)

    def queued_lanes(self, qkey: Optional[Hashable] = None) -> int:
        return sum(
            lanes
            for (_, k), q in self._queues.items()
            if qkey is None or k == qkey
            for _, lanes in q
        )

    def request_count(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def max_request_lanes(self, qkey: Hashable) -> int:
        """Widest queued request at ``qkey`` (0 when empty) — slab sizing."""
        return max(
            (lanes for (_, k), q in self._queues.items() if k == qkey for _, lanes in q),
            default=0,
        )

    def depths(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant queue depth: {tenant: {requests, lanes}}."""
        out: Dict[str, Dict[str, int]] = {}
        for (tenant, _), q in self._queues.items():
            if not q:
                continue
            d = out.setdefault(tenant, {"requests": 0, "lanes": 0})
            d["requests"] += len(q)
            d["lanes"] += sum(lanes for _, lanes in q)
        return out
