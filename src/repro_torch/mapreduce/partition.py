"""Plan-driven key partitioning (paper §3.1.3).

The paper's custom Partitioner hashes intermediate keys into many small
buckets and assigns buckets to reducers in proportion to the plan's ``y_k``
fractions (valid because Equation 3 forces every mapper to use the same
partition function — one-reducer-per-key).  ``bucket_owners`` reproduces
that: ``owners[b]`` is the reducer owning bucket ``b``, with bucket counts
per reducer proportional to ``y``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["hash_keys", "bucket_owners"]


def hash_keys(keys: np.ndarray, n_buckets: int) -> np.ndarray:
    """Deterministic int32 mix (splitmix-style) → bucket ids."""
    x = keys.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(n_buckets)).astype(np.int32)


def bucket_owners(y: np.ndarray, n_buckets: int) -> np.ndarray:
    """Assign ``n_buckets`` hash buckets to reducers proportionally to the
    plan fractions ``y`` (largest-remainder rounding, exact partition)."""
    y = np.asarray(y, dtype=np.float64)
    raw = y * n_buckets
    counts = np.floor(raw).astype(np.int64)
    rem = n_buckets - counts.sum()
    order = np.argsort(-(raw - counts))
    for idx in order[: int(rem)]:
        counts[idx] += 1
    owners = np.repeat(np.arange(len(y)), counts)
    assert owners.shape[0] == n_buckets
    return owners.astype(np.int32)
