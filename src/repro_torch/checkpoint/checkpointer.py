"""Fault-tolerant checkpointing: atomic, async, in the reference's layout.

Layout:  <dir>/step_<N>/
             manifest.json        (step, keys, shapes, dtypes)
             arrays.npz           (flat param/opt arrays, on the host)
             extras.json          (data-pipeline state, rng, metrics)
         <dir>/LATEST             (atomic pointer, written last)

The port of ``repro.checkpoint.checkpointer``, writing the reference's
files exactly, so either package restores the other's checkpoints: keys
are the reference's ``/``-joined key paths, and each stack of layers (a
list of per-layer dictionaries in the port's trees) is stored as ONE
array per leaf with the layers on a leading axis, as the reference's
stacked pytree holds it. npz has no bf16: bf16 leaves are stored widened
to fp32 (losslessly) with ``"bfloat16"`` in the manifest's dtypes, and a
restore casts each array back to its template leaf's type.

Guarantees (the reference's):
  * atomic commit — a checkpoint is visible only after its directory is
    fully written and LATEST is renamed into place; a crash mid-write
    leaves the previous checkpoint intact;
  * async save — arrays are copied to the host synchronously (cheap vs. a
    step; a copy on the CPU too, so the step after the save may update the
    tree in place), then written on a background thread, off the step's
    critical path;
  * restore — arrays go onto each template leaf's device, in its type; a
    shape that differs from the template's raises ``ValueError``; with
    ``shardings`` (a matching tree of ``launch.sharding.NamedSharding``)
    each leaf is placed as a DTensor on the CURRENT mesh — elastic
    re-sharding, as the reference's ``shardings=``;
  * sharded trees — a DTensor leaf is saved whole: gathered leaf by leaf
    on the device of every rank (an all-gather: call ``save`` on all of
    them), copied to the host and written by rank 0 of the process group
    alone. ``wait`` (and so ``save(block=True)``, and the next ``save``)
    then holds every rank until rank 0's write is done, so any rank may
    restore after it;
  * retention — keep the last `keep` checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..carry import reference_leaves, restack, tensor_to_numpy

__all__ = ["Checkpointer"]


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return "bfloat16" if t.dtype == torch.bfloat16 \
            else str(torch.empty((), dtype=t.dtype).numpy().dtype)
    return str(np.asarray(t).dtype)


def _host(t) -> np.ndarray:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return tensor_to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of a group, or the
    only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """{key path: host array (stacks on a leading axis, bf16 widened)},
    {key path: dtype name}; on a rank that does not write, each DTensor
    leaf's gather alone (its part of the collective) and nothing kept."""
    arrays, dtypes = {}, {}
    for path, (ts, stacked) in reference_leaves(tree).items():
        if not _writes():
            for t in ts:
                if isinstance(t, DTensor):
                    t.full_tensor()
            continue
        key = "/".join(path)
        arrays[key] = np.stack([_host(t) for t in ts]) if stacked \
            else _host(ts[0])
        dtypes[key] = _dtype_name(ts[0])
    return arrays, dtypes


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._pending = False   # a save not yet waited for, on every rank

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Dict[str, Any], extras: Optional[Dict] = None,
             block: bool = False) -> None:
        """Snapshot to host, then write asynchronously."""
        self.wait()  # one in-flight save at a time
        flat, dtypes = _flatten(tree)
        extras = dict(extras or {})
        self._pending = True
        if not _writes():
            if block:
                self.wait()
            return

        def _write():
            tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
            try:
                np.savez(os.path.join(tmp, "arrays.npz"), **flat)
                manifest = {
                    "step": step,
                    "keys": sorted(flat),
                    "shapes": {k: list(np.shape(v)) for k, v in flat.items()},
                    "dtypes": dtypes,
                }
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                with open(os.path.join(tmp, "extras.json"), "w") as f:
                    json.dump(extras, f)
                final = os.path.join(self.dir, f"step_{step:08d}")
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                # atomic pointer
                ptr_tmp = os.path.join(self.dir, ".LATEST.tmp")
                with open(ptr_tmp, "w") as f:
                    f.write(f"step_{step:08d}")
                os.replace(ptr_tmp, os.path.join(self.dir, "LATEST"))
                self._gc()
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        """Until the last save is on disk; under a process group every rank
        waits for rank 0's write (call it on all ranks)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending and dist.is_initialized():
            dist.barrier()
        self._pending = False

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, template: Dict[str, Any], step: Optional[int] = None,
                shardings=None) -> Tuple[int, Dict[str, Any], Dict]:
        """Restore into the structure of `template` (a port tree): each
        array on its template leaf's device, in its type; if `shardings`
        (a matching tree of NamedShardings) is given, each is then placed
        by its sharding under the CURRENT mesh."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        data = np.load(os.path.join(d, "arrays.npz"))
        with open(os.path.join(d, "extras.json")) as f:
            extras = json.load(f)

        leaves = reference_leaves(template)
        keys = {path: "/".join(path) for path in leaves}
        missing = [k for k in keys.values() if k not in data.files]
        if missing:
            raise KeyError(f"checkpoint missing arrays: {missing[:5]} ...")

        places = reference_leaves(shardings) if shardings is not None \
            else {}
        restored = {}
        for path, (ts, stacked) in leaves.items():
            k = keys[path]
            arr = data[k]
            want = ((len(ts),) if stacked else ()) + tuple(np.shape(ts[0]))
            if tuple(arr.shape) != want:
                raise ValueError(f"{k}: shape {arr.shape} != template {want}")
            put = lambda a, t: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa: E731
                device=t.device, dtype=t.dtype)
            out = [put(arr[i], t) for i, t in enumerate(ts)] if stacked \
                else [put(arr, ts[0])]
            if path in places:
                out = [s.place(t) for s, t in zip(places[path][0], out)]
            restored[path] = out if stacked else out[0]
        return step, restack(template, restored), extras
