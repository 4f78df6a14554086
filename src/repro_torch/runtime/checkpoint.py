"""Fault-tolerant checkpointing (the port of ``repro/runtime/checkpoint.py``)
with the reference's on-disk layout, so a checkpoint written by either
package restores in the other:

    <dir>/step_<n:08d>/manifest.json — leaf paths, shapes, dtypes, step, extra
    <dir>/step_<n:08d>/arrays.npz    — one entry per leaf
    <dir>/LATEST                      — committed-step pointer (atomic rename)

A leaf's key joins its path's dict keys and sequence indices with "/", as
``jax.tree_util`` paths print (``(params, opt_state)`` gives "0/embed/table"
and "1/count"); dict keys are taken in sorted order, as JAX flattens them.
Everything is written into ``step_<n>.tmp`` and committed by ``os.replace``
of the directory and then of LATEST, so a process dying mid-write leaves the
previous step live.  Leaves are tensors whose types numpy has (the training
state is f32 with an int32 ``count``).

A state laid out over a mesh (``layout=``, a ``sharding/partition.py::
Layout``) is saved as the reference saves a sharded one, full leaves: the
members' blocks are gathered on the caller's thread (every member calls
``save``; the writer thread issues no collective) and the mesh's first
rank writes.  ``restore(..., layout=)`` cuts each full leaf for any mesh,
as the reference's ``restore(shardings=)`` places it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.sharding import partition


def _flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flatten(t, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


def _flatten_specs(specs) -> dict:
    """A spec tree's leaves by the keys :func:`_flatten` gives the tree."""
    out = {}
    partition.map_specs(lambda path, s: out.__setitem__("/".join(path), s),
                        specs)
    return out


def _unflatten_like(tree, values, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(t, values, prefix + (str(i),))
                          for i, t in enumerate(tree))
    return values["/".join(prefix)]


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A tensor leaf as a numpy array that owns its bytes (a CPU tensor is
    copied, so training may go on updating it in place)."""
    return x.detach().to("cpu", copy=True).numpy()


def _gathered(tree, layout):
    """(full tree, whether this process writes): the members' blocks put
    together over ``layout``'s mesh; its first rank writes."""
    if layout is None:
        return tree, True
    full = partition.gather_tree(tree, layout)
    mesh = layout.mesh
    return full, mesh.is_member and mesh.ranks[0] == (
        torch.distributed.get_rank() if torch.distributed.is_initialized()
        else mesh.ranks[0])


def save(ckpt_dir: str, step: int, tree, *, extra: Optional[dict] = None,
         keep: int = 3, layout=None) -> str:
    """Blocking atomic save.  Returns the committed directory.  With
    ``layout`` every member calls it and the mesh's first rank writes."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tree, writer = _gathered(tree, layout)
    if not writer:
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: v if isinstance(v, np.ndarray) else _to_host(v)
            for k, v in _flatten(tree).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    # commit pointer atomically
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"step_{step:08d}")
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep)
    return final


class AsyncCheckpointer:
    """Overlap checkpoint I/O with training (one outstanding save).  The
    device-to-host copy happens on the caller's thread, in stream order,
    before ``save`` returns; the file writes on a worker thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree, extra: Optional[dict] = None,
             layout=None):
        """With ``layout`` every member calls it: the gather runs here, on
        the caller's thread, and only the mesh's first rank starts a
        writer."""
        self.wait()
        tree, writer = _gathered(tree, layout)
        if not writer:
            return
        host_tree = {k: _to_host(v) for k, v in _flatten(tree).items()}

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra=extra,
                     keep=self.keep)
            except BaseException as e:  # surfaced on next save/wait
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        return int(f.read().strip().split("_")[1])


def restore(ckpt_dir: str, tree_like, *, step: Optional[int] = None,
            device=None, layout=None):
    """Restore into the structure of ``tree_like`` -> (tree, step).  Each
    leaf takes its ``tree_like`` leaf's type and lands on ``device`` (by
    default that leaf's device), one leaf at a time, so the host holds one
    leaf's bytes beyond what it keeps.  With ``layout`` each full leaf is
    cut to this member's block (``tree_like``'s leaves give only structure,
    type and device)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    like = _flatten(tree_like)
    specs = _flatten_specs(layout.specs) if layout is not None else {}
    out = {}
    with np.load(os.path.join(d, "arrays.npz")) as z:
        missing = [k for k in like if k not in z.files]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
        for key, ref in like.items():
            dev = device if device is not None else ref.device
            arr = torch.from_numpy(z[key])
            if key in specs:
                arr = partition.shard_leaf(arr, specs[key], layout.mesh)
            out[key] = arr.to(device=dev, dtype=ref.dtype)
    return _unflatten_like(tree_like, out), step


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
