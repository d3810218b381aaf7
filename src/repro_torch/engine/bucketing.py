"""Shape buckets: pad every request to a small set of slab shapes (the port
of ``repro.engine.bucketing``; every function returns the reference's value).

An unconstrained request stream (any oscillator count N, any batch) would
run each distinct shape with its own kernel launch plans and padding.  The
engine instead rounds each request up to a *bucket*:

* **N buckets** (``policy``): the oscillator count is padded up with
  masked oscillators (zero couplings: see
  ``repro_torch.core.dynamics.pad_params`` for the bit-exactness argument).
  ``"pow2"`` rounds to the next power of two (≥ 16, so tiny paper instances
  share one shape); ``"exact"`` disables N padding; an explicit tuple pins
  the allowed sizes.
* **batch buckets** (``batch_buckets``): pending request lanes are
  coalesced and chopped into power-of-two batch slabs, so a stream of
  batch ∈ {1..8} requests runs at most ``len(batch_buckets)`` slab shapes
  instead of eight.

This is the software analog of the paper's serialization/parallelism
trade: a bigger bucket amortizes dispatch (throughput) but pads more
lanes and waits longer to fill (latency); ``repro_torch.engine.planner``
quotes the split.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

NBucketPolicy = Union[str, Sequence[int]]

DEFAULT_BATCH_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128)

#: Smallest pow2 N bucket: below this, padding overhead is noise and every
#: tiny instance (the 3×3/5×4 letter sets) shares one shape.
MIN_POW2_N = 16


def next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def bucket_n(n: int, policy: NBucketPolicy = "pow2") -> int:
    """The padded oscillator count a size-``n`` instance is served at."""
    if n <= 0:
        raise ValueError(f"bucket_n: n={n} must be positive")
    if policy == "exact":
        return n
    if policy == "pow2":
        return max(MIN_POW2_N, next_pow2(n))
    sizes = sorted(int(s) for s in policy)
    for s in sizes:
        if s >= n:
            return s
    raise ValueError(f"bucket_n: n={n} exceeds largest bucket {sizes[-1]}")


def bucket_batch(lanes: int, buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS) -> int:
    """Smallest batch bucket that holds ``lanes`` lanes (≤ max bucket)."""
    if lanes <= 0:
        raise ValueError(f"bucket_batch: lanes={lanes} must be positive")
    for b in sorted(buckets):
        if b >= lanes:
            return b
    return max(buckets)


def chop(lanes: int, buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS) -> Tuple[int, ...]:
    """Split ``lanes`` pending lanes into bucket-sized slabs, greedily.

    Full max-size slabs first (throughput), then the smallest bucket that
    covers the remainder (bounded pad waste).  Σ slabs ≥ lanes always.
    """
    if lanes <= 0:
        return ()
    srt = sorted(buckets)
    biggest = srt[-1]
    slabs = [biggest] * (lanes // biggest)
    rem = lanes % biggest
    if rem:
        slabs.append(bucket_batch(rem, srt))
    return tuple(slabs)


def pad_waste(lanes: int, slabs: Sequence[int]) -> float:
    """Fraction of served lanes that are padding (0 when slabs fit exactly)."""
    total = sum(slabs)
    return 0.0 if total == 0 else (total - lanes) / total
