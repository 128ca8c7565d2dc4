"""Checkpoints of tensor trees with async writes and crash-safe publish.

The port of ``repro.checkpoint.checkpoint``, with the same layout: one
directory ``step_<8 digits>`` per step holding

* ``manifest.json``: the step, the caller's ``extra`` and, per leaf, its
  path string, file, shape, dtype and logical sharding: the leaf's spec
  (:mod:`repro_torch.distributed.shardings`, a list of null, an axis
  name or a list of names a dimension), or null where the caller gave
  none;
* ``<leaf-hash>.npy``: one file per leaf, whole, copied to the host.
  numpy has no bfloat16, so a bf16 leaf is stored as its int16 bits and
  named ``bfloat16`` in the manifest.

On a mesh with a process group the manager gathers one leaf at a time
(a collective on every rank) and rank 0 copies it to the host and writes
it once; a barrier follows.
A restore given specs cuts each whole leaf to the current mesh's block,
whatever mesh wrote the checkpoint (the reference's
``restore_checkpoint(..., shardings=)``).

Writes go to ``step_<n>.tmp`` and are renamed into place, so a crash
mid-write never corrupts the latest complete checkpoint.  Async mode
copies the tree to the host on the caller's thread and hands the write to
a daemon thread; ``wait()`` blocks until every pending write is durable
and raises the first writer error.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.distributed import sharded
from repro_torch.train.tree import leaves_with_path, path_str, tree_map

__all__ = ["CheckpointManager", "latest_step", "restore_checkpoint",
           "save_checkpoint"]


def _leaf_file(ps: str) -> str:
    return hashlib.sha1(ps.encode()).hexdigest()[:16] + ".npy"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy that later in-place updates of ``t`` cannot reach."""
    return t.detach().to("cpu", copy=True)


def _spec_json(spec, leaf) -> Optional[list]:
    if spec is None:
        return None
    return [e if e is None or isinstance(e, str) else list(e)
            for e in sharded.leaf_spec(spec, leaf)]


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict] = None, specs: Any = None) -> str:
    """Synchronous save of the whole leaves of ``tree``, with ``specs`` (a
    tree of specs like it) in the manifest.  Returns the checkpoint
    path."""
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    tmp_dir = ckpt_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    spec_leaves = (iter(s for _, s in leaves_with_path(specs))
                   if specs is not None else None)
    for path, leaf in leaves_with_path(tree):
        ps = path_str(path)
        fname = _leaf_file(ps)
        np.save(os.path.join(tmp_dir, fname), _to_numpy(leaf))
        spec = next(spec_leaves) if spec_leaves is not None else None
        manifest["leaves"].append(
            {"path": ps, "file": fname, "shape": list(leaf.shape),
             "dtype": _dtype_name(leaf.dtype),
             "logical_sharding": _spec_json(spec, leaf)})
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    os.rename(tmp_dir, ckpt_dir)   # atomic publish
    return ckpt_dir


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name,
                                           "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: Any,
                       specs: Any = None, mesh=None) -> Any:
    """The checkpoint of ``step`` in the structure of ``like``, each leaf
    on the device and in the dtype of ``like``'s leaf.  Given ``specs``
    (a tree of specs like ``like``) and ``mesh``, each whole leaf is cut
    to this rank's block on ``mesh`` first, and ``like`` holds blocks."""
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def one(path, leaf, spec=None):
        ps = path_str(path)
        if ps not in by_path:
            raise KeyError(f"checkpoint missing leaf {ps}")
        entry = by_path[ps]
        t = torch.from_numpy(np.load(os.path.join(ckpt_dir, entry["file"])))
        if entry["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if spec is not None:
            t = sharded.local_block(t, spec, mesh)
        if list(t.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch for {ps}: ckpt {tuple(t.shape)}"
                             f" vs expected {tuple(leaf.shape)}")
        return t.to(device=leaf.device, dtype=leaf.dtype)

    if specs is None:
        return tree_map(one, like, with_path=True)
    return tree_map(one, like, specs, with_path=True)


class CheckpointManager:
    """Async checkpoint writer with a bounded queue and crash-safe publish.

    With a ``mesh`` that has a process group, :meth:`save` and :meth:`wait`
    are collective: every rank calls them, rank 0 writes."""

    def __init__(self, directory: str, keep: int = 3,
                 async_mode: bool = True, mesh=None):
        self.directory = directory
        self.keep = keep
        self.async_mode = async_mode
        self.mesh = mesh
        self._writer = mesh is None or mesh.rank == 0
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._errors: list = []
        self._thread = None
        if async_mode and self._writer:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, tree, extra, specs = item
            try:
                save_checkpoint(self.directory, step, tree, extra, specs)
                self._gc()
            except Exception as e:  # surfaced on wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             specs: Any = None):
        """Save ``tree`` (this rank's blocks under ``specs`` on a mesh
        with a group; whole leaves otherwise)."""
        grouped = self.mesh is not None and self.mesh.group is not None
        if grouped:
            # one leaf at a time: a whole leaf lives on the device only
            # until rank 0 has copied it to the host
            def whole(t, spec):
                w = sharded.gather_leaf(t, spec, self.mesh)
                return _host_copy(w) if self._writer else None
            tree = tree_map(whole, tree, specs)
        if self._writer:
            if self.async_mode:
                # copy to the host here: the caller updates the tensors in
                # place after this returns
                if not grouped:
                    tree = tree_map(_host_copy, tree)
                self._q.put((step, tree, extra, specs))
            else:
                save_checkpoint(self.directory, step, tree, extra, specs)
                self._gc()
        if grouped:
            sharded.barrier(self.mesh)

    def wait(self):
        """Block until every write is durable (on every rank of a group)
        and raise the first writer error."""
        try:
            if self.async_mode and self._writer:
                self._q.join()
        finally:
            if self.mesh is not None:
                sharded.barrier(self.mesh)
        if self._errors:
            raise self._errors[0]

    def close(self):
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=60)
            self._thread = None

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)
