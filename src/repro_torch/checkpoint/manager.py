"""Atomic checkpoints of optimizer states (port of ``repro/checkpoint``).

The on-disk format is the reference's, so each package restores the
other's checkpoints: a directory ``step_%010d`` holding ``arrays.npz``
(one array per state leaf) and ``manifest.json`` (step, time, ``extra``,
``metrics`` and each leaf's shape and dtype).  A save writes a temporary
directory and commits it with one ``os.replace``, so a failure mid-write
never corrupts the latest committed step; the oldest steps beyond
``keep`` are then removed.

Leaf keys are spelled as JAX's ``tree_flatten_with_path`` spells them for
the reference's NamedTuples: attribute names with a leading dot, dict keys
and sequence indices as they are, joined by ``//`` (``.inner//.phi_i``,
``.cache//.gram``, ``.pending//.ids``).  The port's states keep host
counters as Python ints and bools and the pending buffer's ids and flags
as numpy arrays; they are stored as the reference stores its device
scalars: 0-d int32 and bool arrays, ids as int32.  A leaf that is None is
absent.  bfloat16 is widened to float32 (lossless); the template's dtype
restores it.  A sharded run writes the same files, its state gathered
first, and :func:`restore_resharded` places them on any data mesh.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

SEP = "//"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """``(key, child)`` pairs of a NamedTuple, dict, list or tuple, else
    None for a leaf."""
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf, dtype=bool)
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, dtype=np.int32)
    a = np.asarray(leaf)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """The state's leaves as numpy arrays, under JAX's path keys."""
    kids = _children(tree)
    if kids is None:
        return {} if tree is None else {prefix: _to_numpy(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in kids:
        out.update(flatten(v, f"{prefix}{SEP}{k}" if prefix else k))
    return out


def _like(template, arr: np.ndarray):
    """``arr`` as the template leaf's type, dtype and device."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr, copy=True)).to(
            device=template.device, dtype=template.dtype)
    if isinstance(template, (bool, np.bool_)):
        return bool(arr)
    if isinstance(template, (int, np.integer)):
        return int(arr)
    if isinstance(template, np.ndarray):
        return np.array(arr, dtype=template.dtype)
    raise TypeError(f"cannot restore a leaf of type {type(template)}")


def _unflatten(template, data, prefix: str = ""):
    kids = _children(template)
    if kids is None:
        return None if template is None else _like(template, data[prefix])
    vals = [_unflatten(v, data, f"{prefix}{SEP}{k}" if prefix else k)
            for k, v in kids]
    if _is_namedtuple(template):
        return type(template)(*vals)
    if isinstance(template, dict):
        return dict(zip(template.keys(), vals))
    return type(template)(vals)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:010d}"

    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             metrics: Optional[dict] = None) -> None:
        """Write ``tree`` under ``step``: a temporary directory, committed
        by one rename, then garbage collection beyond ``keep``."""
        tmp = self.dir / f".tmp_step_{step:010d}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays = flatten(tree)
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "extra": extra or {},
            "metrics": metrics or {},
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in arrays.items()},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # the commit
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self):
        """Committed steps (those with a manifest), ascending."""
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*")
                      if (p / "manifest.json").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _resolve(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return step

    def load_manifest(self, step: Optional[int] = None) -> dict:
        """A checkpoint's manifest, without reading its arrays."""
        d = self._step_dir(self._resolve(step))
        return json.loads((d / "manifest.json").read_text())

    def restore(self, template: Any, step: Optional[int] = None):
        """The checkpoint in the structure, types, dtypes and devices of
        ``template``.  Returns ``(tree, manifest)``."""
        d = self._step_dir(self._resolve(step))
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as data:
            tree = _unflatten(template, data)
        return tree, manifest


def restore_resharded(mgr: CheckpointManager, template: Any, mesh,
                      step: Optional[int] = None):
    """Elastic restart: the checkpoint's global arrays, placed on ``mesh``
    (a :class:`repro_torch.launch.mesh.DataMesh`): an MP-BCFW state (or
    the ``mp`` of a pipelined one) sliced to this rank's blocks, every
    other tensor moved to the mesh's device.  The world size that wrote
    the files does not matter (they hold the global arrays, as a
    single-device run writes them), nor does the package.  ``template``
    gives the structure, types and dtypes (a global or a rank's state).
    Returns ``(tree, manifest)``."""
    from ..shard.layout import place_tree
    tree, manifest = mgr.restore(template, step)
    return place_tree(tree, mesh), manifest
