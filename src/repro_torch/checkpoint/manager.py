"""Fault-tolerant checkpointing: atomic save, async writer, integrity
manifest, latest-valid discovery for auto-resume after preemption (port of
``repro.checkpoint.manager``, with its on-disk format, so a checkpoint
written by either package restores into the other).

Layout:  <dir>/step_00000100/
            manifest.json   (tree paths, shapes, dtypes, checksums, metadata)
            arrays.npz      (every leaf, keyed by its ``/``-joined tree path)
            COMMITTED       (written last -> atomicity marker)

A step is written under ``step_XXXXXXXX.tmp`` and renamed into place once
``COMMITTED`` is in it, so a torn write is never taken for a checkpoint.

Under a mesh every rank calls ``save``: each DTensor leaf is gathered whole
(a collective) and rank 0 writes; the others wait for the write on the next
``wait``.  A checkpoint holds host arrays and no layout, so ``restore(...,
sharding_fn=)`` distributes each leaf onto the live mesh, whatever mesh
wrote it (a resharded restore: elastic training after losing cards).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import current_mesh_info, full_value
from repro_torch.utils import tree_flatten, tree_map, tree_unflatten


def _to_host(tree: Any) -> Any:
    """A host copy of every leaf: the optimizer updates the live tensors in
    place while the writer thread runs, so a CPU tensor is copied too.  A
    DTensor is gathered whole first."""
    return tree_map(lambda t: full_value(t.detach()).to("cpu", copy=True)
                    .numpy(), tree)


def _distribute(leaf: torch.Tensor, mesh: Any, placements) -> torch.Tensor:
    from torch.distributed.tensor import Replicate, distribute_tensor

    if placements is None:
        placements = [Replicate()] * mesh.ndim
    return distribute_tensor(leaf, mesh, placements)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._pending = False  # a save under a process group not yet met
        #: this process writes: the only one, or rank 0 of the group
        self.writer = not dist.is_initialized() or dist.get_rank() == 0
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, metadata: dict | None = None) -> None:
        """Copy ``tree`` (nested dicts of tensors) to host numpy now, then
        write it, on the writer thread when ``async_write``.  One write is in
        flight at a time; a failed write raises on the next ``save`` or
        ``wait``."""
        host_tree = _to_host(tree)
        self.wait()
        self._pending = dist.is_initialized()
        if not self.writer:
            return
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_tree, metadata or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_tree, metadata or {})

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            # every rank meets rank 0 once its write is on disk
            self._pending = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host_tree: Any, metadata: dict) -> None:
        try:
            final = self._step_dir(step)
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            flat = dict(tree_flatten(host_tree))
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            manifest = {
                "step": step,
                "time": time.time(),
                "metadata": metadata,
                "arrays": {
                    k: {
                        "shape": list(v.shape),
                        "dtype": str(v.dtype),
                        "sha1_16": hashlib.sha1(
                            np.ascontiguousarray(v).tobytes()[:65536]).hexdigest(),
                    }
                    for k, v in flat.items()
                },
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
        except Exception as e:  # surfaced on the next wait()/save()
            self._error = e

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "COMMITTED")):
                    steps.append(int(name[5:]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def nbytes(self, step: int) -> int:
        """Bytes on disk of committed step ``step``."""
        d = self._step_dir(step)
        return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))

    def restore(self, step: int, like: Any,
                device: torch.device | str = "cuda",
                sharding_fn: Callable[[str], Any] | None = None) -> Any:
        """The tree of ``like`` (nested dicts whose leaves have a ``shape``)
        filled from step ``step``, as tensors on ``device``.  With
        ``sharding_fn``, ``sharding_fn(key)`` gives each leaf's placements
        on the active mesh (``use_mesh_info``; None: replicated), and the
        leaf is distributed onto that mesh from the host array.  Raises
        ``KeyError`` for a leaf the checkpoint lacks and ``ValueError`` for
        one whose shape differs."""
        mesh = None
        if sharding_fn is not None:
            info = current_mesh_info()
            if info is None:
                raise RuntimeError("restore(sharding_fn=...) needs an active "
                                   "mesh (use_mesh_info)")
            mesh = info.mesh
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = []
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for key, proto in tree_flatten(like):
                if key not in manifest["arrays"]:
                    raise KeyError(f"checkpoint missing array {key!r}")
                arr = data[key]
                if tuple(arr.shape) != tuple(proto.shape):
                    raise ValueError(f"{key}: shape {arr.shape} != "
                                     f"{tuple(proto.shape)}")
                leaf = torch.from_numpy(arr).to(device)
                if mesh is not None:
                    leaf = _distribute(leaf, mesh, sharding_fn(key))
                leaves.append(leaf)
        return tree_unflatten(like, leaves)

    def restore_latest(self, like: Any, device: torch.device | str = "cuda",
                       sharding_fn: Callable[[str], Any] | None = None
                       ) -> tuple[int, Any] | None:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, like, device, sharding_fn)

    def metadata(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)["metadata"]

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")
