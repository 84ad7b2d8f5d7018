"""Checkpointing: atomic commit, async save, retention —
:mod:`repro.train.checkpoint` for the port's tensors, on the reference's
on-disk layout (one directory per step)::

    <dir>/step_000123/
        MANIFEST.json        # {path: {shape, dtype, file}}, step, extras
        arrays/<idx>.npy     # one .npy per leaf (host numpy)
        COMMITTED            # written last — a checkpoint without it is
                             # garbage from a crashed save and is ignored

Leaf paths are the strings jax's ``keystr`` gives the same tree
(``.params['groups']['blk0']['mixer']['wq']``, ``.opt.step``), and files
are numbered in the order of those strings, so a checkpoint written by
either package restores into the other's train state.

* **atomic**: the COMMITTED marker is written after every array fsync; a
  failure mid-save can never produce a checkpoint that restores.
* **async**: ``save_async`` copies every tensor to host memory at once
  (the train step then updates its tensors in place) and writes in a
  background thread.  One write runs at a time: ``save`` first waits for
  a pending async write, so two saves of one step cannot race to rename
  into the same directory, and the later save's state is the one kept.
* **retention**: keep the newest ``keep`` checkpoints, always preserving
  any checkpoint marked ``milestone``.
* **restore** puts each leaf on the device and in the dtype of the
  matching leaf of ``like``; with ``shardings`` (a matching tree of
  :class:`~repro_torch.models.sharding.NamedSharding`) each stored full
  array is distributed to its target placements, whatever mesh they
  belong to: the elastic re-shard.
* **sharded state**: a DTensor leaf is gathered in full
  (``full_tensor()``, a collective: every rank of the mesh must call
  ``save``), and rank 0 of the default process group alone writes.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager"]

_MARKER = "COMMITTED"


def _leaf_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{keystr path: tensor} of a tree of named tuples and dicts (jax's
    ``keystr`` spellings: ``.field``, ``['key']``)."""
    out: Dict[str, Any] = {}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            out.update(_leaf_paths(getattr(tree, name), f"{prefix}.{name}"))
    elif isinstance(tree, dict):
        for key in sorted(tree):
            out.update(_leaf_paths(tree[key], f"{prefix}[{key!r}]"))
    else:
        out[prefix] = tree
    return out


def _rebuild(like, leaves: Dict[str, Any], prefix: str = ""):
    """``like``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, n), leaves, f"{prefix}.{n}")
                            for n in like._fields))
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    return leaves[prefix]


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor that later in-place updates cannot reach; a
    DTensor is gathered in full first."""
    if hasattr(leaf, "full_tensor"):
        leaf = leaf.full_tensor()
    return leaf.detach().to("cpu", copy=True).numpy()


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of the default
    process group, or a process without one."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- enumeration -------------------------------------------------------
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.dir, name, _MARKER)
            ):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree, extras: Optional[dict] = None,
             milestone: bool = False):
        """Synchronous atomic save, after any pending async save has been
        written (the launcher saves its last step both ways)."""
        self.wait()
        snapshot = {p: _to_host(a) for p, a in _leaf_paths(tree).items()}
        if not _writes():
            return
        self._write(step, snapshot, extras or {}, milestone)
        self._gc()

    def save_async(self, step: int, tree, extras: Optional[dict] = None,
                   milestone: bool = False):
        """Snapshot now, write in the background.  Raises any error from the
        previous async save (so failures are not silent)."""
        self.wait()
        snapshot = {p: _to_host(a) for p, a in _leaf_paths(tree).items()}
        if not _writes():
            return

        def work():
            try:
                self._write(step, snapshot, extras or {}, milestone)
                self._gc()
            except BaseException as e:  # surfaced on next save/wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, snapshot: Dict[str, np.ndarray], extras: dict,
               milestone: bool):
        final = self._step_dir(step)
        tmp = tempfile.mkdtemp(prefix=".tmp_save_", dir=self.dir)
        try:
            arrays_dir = os.path.join(tmp, "arrays")
            os.makedirs(arrays_dir)
            manifest = {"step": step, "milestone": milestone, "extras": extras,
                        "leaves": {}}
            for i, (path, arr) in enumerate(sorted(snapshot.items())):
                fname = f"{i}.npy"
                with open(os.path.join(arrays_dir, fname), "wb") as f:
                    np.save(f, arr)
                    f.flush()
                    os.fsync(f.fileno())
                manifest["leaves"][path] = {
                    "shape": list(arr.shape),
                    "dtype": str(arr.dtype),
                    "file": fname,
                }
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, _MARKER), "w") as f:
                f.write("ok")
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _gc(self):
        steps = self.steps()
        if len(steps) <= self.keep:
            return
        for s in steps[: -self.keep]:
            d = self._step_dir(s)
            try:
                with open(os.path.join(d, "MANIFEST.json")) as f:
                    if json.load(f).get("milestone"):
                        continue
            except OSError:
                pass
            shutil.rmtree(d, ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def restore(self, step: Optional[int], like, shardings=None):
        """Restore into the structure of ``like`` (a tree of tensors): each
        stored array lands on the device and in the dtype of ``like``'s leaf
        at its path.  ``shardings``: optional matching tree of
        ``NamedSharding`` (``None`` leaves stay full) — the elastic
        re-shard path: the stored full arrays are distributed with the
        *target* placements, whatever mesh they belong to (a collective
        over that mesh).  ``step=None`` takes the newest committed step.
        Returns (tree, extras, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        d = self._step_dir(step)
        if not os.path.exists(os.path.join(d, _MARKER)):
            raise FileNotFoundError(f"checkpoint step {step} is not committed")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        stored = manifest["leaves"]
        want = _leaf_paths(like)
        missing = set(want) - set(stored)
        if missing:
            raise KeyError(f"checkpoint lacks leaves: {sorted(missing)[:5]} ...")
        placing = _leaf_paths(shardings) if shardings is not None else {}
        out = {}
        for path, leaf in want.items():
            arr = np.load(os.path.join(d, "arrays", stored[path]["file"]))
            want_shape = tuple(leaf.shape)
            if tuple(arr.shape) != want_shape:
                raise ValueError(
                    f"{path}: stored {arr.shape} != wanted {want_shape}"
                )
            out[path] = torch.from_numpy(arr).to(device=leaf.device,
                                                 dtype=leaf.dtype)
            if placing.get(path) is not None:
                out[path] = placing[path].place(out[path])
        return _rebuild(like, out), manifest["extras"], step
