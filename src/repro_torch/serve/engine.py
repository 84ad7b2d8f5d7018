"""Batched serving engine: continuous batching over a fixed decode grid.

The port of :mod:`repro.serve.engine`:

* requests queue up with prompt tokens and a max_new_tokens budget;
* the engine keeps ``slots`` concurrent sequences in a shared cache
  (slot = batch row), admitting new requests into freed slots each step
  (**continuous batching** — no head-of-line blocking on long generations);
* prefill runs per admission (right-padded into the slot's cache);
* one decode step advances *all* slots;
* per-request metrics: TTFT (steps to first token) and decode steps.

Greedy sampling by default; temperature optional.  Where the port differs
from the reference, on purpose:

* the prefill cache is merged into the shared cache leaf by leaf on the
  leaf's own slot axis — axis 1 of the group-stacked ``(G, B, ...)`` leaves,
  axis 0 of the ``tail`` leaves ``(B, ...)``.  The reference merges only
  where axis 1 has ``slots`` entries, so RecurrentGemma's tail blocks keep
  the previous request's recurrent state (or, at ``slots == 3``, take the
  new one on the wrong axis);
* ``ServeConfig.use_kernels`` reaches prefill and decode (the reference
  never reads it), so on the card the Hopper kernels serve;
* the shared cache is updated in place;
* sampling at ``temperature > 0`` draws from the engine's
  ``torch.Generator`` seeded with ``ServeConfig.seed``: not ``jax.random``'s
  bits.

``ServeEngine(..., mesh=)`` serves on a ``DeviceMesh`` with a ``"model"``
dim, as the reference's engine takes one.  Every rank of the mesh runs the
same loop on the same requests:

* the parameters rest as the active rules place them
  (:func:`repro_torch.models.model.place_params`; ``INFERENCE_RULES``
  replicate them over ``"data"``), every layer tensor parallel;
* the cache's slots go over the batch axes where they divide (else every
  rank holds them all), its kv heads and Mamba/RG-LRU channels over
  ``"model"``;
* an admission's prefill (one request) runs on every rank, and the rank
  holding the slot keeps its cache; a decode step advances this rank's
  slots, and the next-token logits are assembled over ``"model"`` and the
  batch axes, so every rank samples every slot alike.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models import model as M
from ..models import sharding as S
from ..models.config import ArchConfig

__all__ = ["Request", "ServeConfig", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (T,) int32
    max_new_tokens: int
    temperature: float = 0.0
    # filled by the engine:
    output: Optional[List[int]] = None
    ttft_steps: Optional[int] = None
    done: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 4
    max_len: int = 512
    compute_dtype: torch.dtype = torch.float32
    use_kernels: bool = True
    seed: int = 0


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, scfg: ServeConfig,
                 device=None, mesh=None):
        """``params`` whole (alike on every rank with ``mesh``); ``cfg``
        padded for the mesh's ``"model"`` ranks
        (``configs.padded_for_tp``)."""
        if cfg.frontend is not None:
            raise ValueError(f"{cfg.name}: the serving loop drives token-in "
                             "archs")
        self.device = resolve_device(device)
        self.cfg, self.scfg, self.mesh = cfg, scfg, mesh
        # the reference casts the weights to compute_dtype on every call;
        # here once (a no-op for parameters already in it)
        self.params = M.cast_params(params, scfg.compute_dtype, self.device)
        # this rank's slots: [lo, lo + rows)
        self.batch_axes = tuple(a for a in S.BATCH_AXES
                                if S.axis_size(mesh, a) > 1)
        nb, index = 1, 0
        for a in self.batch_axes:
            nb, index = nb * S.axis_size(mesh, a), (
                index * S.axis_size(mesh, a) + S.axis_rank(mesh, a))
        if scfg.slots % nb:
            nb, index, self.batch_axes = 1, 0, ()
        self.rows = scfg.slots // nb
        self.lo = index * self.rows
        if mesh is not None:
            self.params = M.place_params(cfg, self.params, mesh)
        # float32 whatever the compute dtype, as in the reference
        self.cache = M.init_cache(cfg, self.rows, scfg.max_len,
                                  dtype=torch.float32, device=self.device,
                                  mesh=mesh)
        self.slot_req: List[Optional[Request]] = [None] * scfg.slots
        self.slot_pos = np.zeros(scfg.slots, np.int64)
        self.pending: List[Request] = []
        self.step_count = 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(scfg.seed)

    # -- public API -----------------------------------------------------------
    def submit(self, req: Request):
        req.output = []
        self.pending.append(req)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive the loop until all submitted requests finish."""
        finished: List[Request] = []
        for _ in range(max_steps):
            self._admit()
            if all(r is None for r in self.slot_req) and not self.pending:
                break
            finished.extend(self._step())
        return finished

    # -- internals ----------------------------------------------------------
    def _admit(self):
        for s in range(self.scfg.slots):
            if self.slot_req[s] is None and self.pending:
                self._prefill_into_slot(s, self.pending.pop(0))

    def _merge(self, s: int, one) -> None:
        """Write the B=1 prefill cache ``one`` into slot ``s`` of the shared
        cache, each leaf on its own slot axis; other slots are untouched.
        On a mesh, only the rank that holds slot ``s`` keeps it."""
        if not self.lo <= s < self.lo + self.rows:
            return
        s -= self.lo
        for name, leaves in self.cache.items():
            if name == "tail":
                for blk, tail_leaves in leaves.items():
                    for k, full in tail_leaves.items():
                        full[s].copy_(one["tail"][blk][k][0])
            else:
                for k, full in leaves.items():
                    full[:, s].copy_(one[name][k][:, 0])

    def _prefill_into_slot(self, s: int, req: Request):
        """Per-slot B=1 prefill merged into the shared cache at slot ``s``
        — other slots' KV rows and recurrent state are untouched, which is
        what makes continuous batching correct for SSM/hybrid archs too."""
        T = len(req.prompt)
        if T + req.max_new_tokens > self.scfg.max_len:
            raise ValueError(f"request {req.rid}: prompt {T} + "
                             f"{req.max_new_tokens} new tokens exceed "
                             f"max_len {self.scfg.max_len}")
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64)[None],
                                 device=self.device)
        logits, cache1, _ = M.prefill(
            self.cfg, self.params, {"tokens": tokens},
            max_cache_len=self.scfg.max_len, use_kernels=self.scfg.use_kernels,
            mesh=self.mesh,
        )
        self._merge(s, cache1)
        last = S.assemble(logits[0, T - 1], self.mesh, ("model",), 0)
        req.output.append(int(torch.argmax(last)))
        req.ttft_steps = self.step_count + 1
        self.slot_req[s] = req
        self.slot_pos[s] = T

    def _step(self) -> List[Request]:
        active = [s for s in range(self.scfg.slots) if self.slot_req[s] is not None]
        if not active:
            return []
        tokens = np.zeros((self.scfg.slots, 1), np.int64)
        positions = np.zeros((self.scfg.slots, 1), np.int64)
        for s in active:
            tokens[s, 0] = self.slot_req[s].output[-1]
            positions[s, 0] = self.slot_pos[s]
        mine = slice(self.lo, self.lo + self.rows)
        logits, _, _ = M.decode_step(
            self.cfg, self.params,
            {"tokens": torch.as_tensor(tokens[mine], device=self.device),
             "positions": torch.as_tensor(positions[mine],
                                          device=self.device)},
            self.cache, use_kernels=self.scfg.use_kernels, mesh=self.mesh,
        )
        # every slot's whole logits on every rank
        logits = S.assemble(S.assemble(logits[:, -1], self.mesh, ("model",),
                                       1), self.mesh, self.batch_axes, 0)
        greedy = logits.argmax(dim=-1).tolist()
        self.step_count += 1
        done: List[Request] = []
        for s in active:
            req = self.slot_req[s]
            if req.temperature > 0:
                probs = torch.softmax(logits[s] / req.temperature, dim=-1)
                nxt = int(torch.multinomial(probs, 1, generator=self.generator))
            else:
                nxt = greedy[s]
            req.output.append(nxt)
            self.slot_pos[s] += 1
            if len(req.output) >= req.max_new_tokens:
                req.done = True
                done.append(req)
                self.slot_req[s] = None
        return done
