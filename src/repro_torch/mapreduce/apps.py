"""The paper's three evaluation applications (§4.6.2), on the plan-driven
engine — plus the synthetic α-controlled job used for model validation
(§3.2).

* **Word Count** — heavy aggregation, in-mapper combining (α ≈ 0.09 in the
  paper; here α is whatever the generated corpus yields, measured).
* **Sessionization** — a distributed sort: identity map keyed by user, the
  reducer orders each user's log entries by timestamp and cuts sessions at
  gaps > threshold (α = 1.0).
* **Full Inverted Index** — positional index over (doc, word) pairs; the
  intermediate records append position info, so α > 1.

Values are packed into int64s (value packing stands in for serialized
records; byte accounting uses the app's record sizes).  Word count's reduce
hot loop runs the Hopper ``segment_sum`` kernel via
:mod:`repro_torch.kernels.ops`, on the card unless the app was built with
``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..kernels import ops as kops
from .engine import MRApp

__all__ = [
    "word_count",
    "sessionization",
    "inverted_index",
    "synthetic_alpha_job",
    "generate_documents",
    "generate_logs",
]


# ---------------------------------------------------------------------------
# corpora
# ---------------------------------------------------------------------------

def generate_documents(
    n_docs: int, words_per_doc: int, vocab: int = 10_000, seed: int = 0
):
    """(doc_id keys, word values) — Zipf-distributed words."""
    rng = np.random.default_rng(seed)
    words = np.minimum(rng.zipf(1.4, size=n_docs * words_per_doc), vocab) - 1
    doc_ids = np.repeat(np.arange(n_docs), words_per_doc)
    pos = np.tile(np.arange(words_per_doc), n_docs)
    # value packs (doc_id, position, word)
    packed = (doc_ids.astype(np.int64) << 40) | (pos.astype(np.int64) << 20) | words
    return doc_ids.astype(np.int64), packed


def generate_logs(n_entries: int, n_users: int = 500, seed: int = 0):
    """WorldCup-trace-like web log: (user, timestamp) pairs."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, size=n_entries).astype(np.int64)
    ts = np.sort(rng.integers(0, 10_000_000, size=n_entries)).astype(np.int64)
    packed = (users << 32) | ts
    return users, packed


# ---------------------------------------------------------------------------
# applications
# ---------------------------------------------------------------------------

def word_count(use_kernel: bool = True,
               device: Optional[DeviceLike] = None) -> MRApp:
    """Word count; its reduce sums on ``device`` (default: the process
    default, the card), resolved at each reduce call."""

    def map_fn(keys, values) -> Tuple[np.ndarray, np.ndarray]:
        words = (values & ((1 << 20) - 1)).astype(np.int64)
        # in-mapper combining (Lin & Dyer): emit (word, count) once per word
        uniq, counts = np.unique(words, return_counts=True)
        return uniq, counts.astype(np.int64)

    def reduce_fn(keys, values):
        dev = resolve_device(device)
        uniq, start = np.unique(keys, return_index=True)
        seg = np.searchsorted(uniq, keys).astype(np.int32)
        # float32 round trip as in the reference: exact below 2^24 per word
        sums = kops.sorted_segment_sum(
            torch.from_numpy(np.asarray(values, np.float32)[:, None]).to(dev),
            torch.from_numpy(seg).to(dev),
            int(uniq.shape[0]),
            use_kernel=use_kernel,
        )
        return uniq, sums[:, 0].cpu().numpy().astype(np.int64)

    return MRApp(
        name="word_count", map_fn=map_fn, reduce_fn=reduce_fn,
        record_bytes=16, intermediate_record_bytes=16,
    )


def sessionization(gap: int = 30_000) -> MRApp:
    def map_fn(keys, values):
        return keys, values  # identity: route by user id

    def reduce_fn(keys, values):
        # values already grouped by key (engine sorts by key); order each
        # user's entries by timestamp and cut sessions at large gaps.
        ts = (values & ((1 << 32) - 1)).astype(np.int64)
        order = np.lexsort((ts, keys))
        k, t = keys[order], ts[order]
        new_user = np.concatenate([[True], k[1:] != k[:-1]])
        big_gap = np.concatenate([[False], (t[1:] - t[:-1]) > gap])
        session_start = new_user | big_gap
        session_id = np.cumsum(session_start) - 1
        return k, ((session_id.astype(np.int64) << 32) | t)

    return MRApp(
        name="sessionization", map_fn=map_fn, reduce_fn=reduce_fn,
        record_bytes=16, intermediate_record_bytes=16,
    )


def inverted_index() -> MRApp:
    def map_fn(keys, values):
        words = (values & ((1 << 20) - 1)).astype(np.int64)
        doc = (values >> 40).astype(np.int64)
        pos = ((values >> 20) & ((1 << 20) - 1)).astype(np.int64)
        # posting carries (doc, position) — the "full" index: α > 1 in byte
        # terms (intermediate records are bigger than inputs).
        return words, (doc << 20) | pos

    def reduce_fn(keys, values):
        order = np.lexsort((values, keys))
        return keys[order], values[order]

    return MRApp(
        name="inverted_index", map_fn=map_fn, reduce_fn=reduce_fn,
        record_bytes=8, intermediate_record_bytes=16,
    )


def synthetic_alpha_job(alpha: float) -> MRApp:
    """The §3.2 synthetic job: mappers re-emit each record ``alpha×`` (in
    expectation) with an identity reduce — direct control over the data
    expansion factor."""

    def map_fn(keys, values):
        n = keys.shape[0]
        whole = int(np.floor(alpha))
        frac = alpha - whole
        reps = np.full(n, whole, np.int64)
        if frac > 0:
            # deterministic fractional expansion: first round(frac*n)
            reps[: int(round(frac * n))] += 1
        return np.repeat(keys, reps), np.repeat(values, reps)

    def reduce_fn(keys, values):
        return keys, values

    return MRApp(
        name=f"synthetic_alpha_{alpha}", map_fn=map_fn, reduce_fn=reduce_fn,
        record_bytes=8, intermediate_record_bytes=8,
    )
