"""Fault-tolerant checkpointing: atomic and resumable, in the reference's
on-disk layout (`repro.ft.checkpoint`), so a plain tree of dicts, lists
and tensors saved by one package restores in the other.

Layout:  <dir>/step_<N>/
           manifest.json     - keys, shapes, dtypes, step, extra
           arrays.npz        - the leaves, keyed by their /-joined paths
         <dir>/LATEST        - atomically renamed pointer file

  * save() writes step_<N>.tmp, then os.replace()s it into place, then
    points LATEST at it through LATEST.tmp and os.replace(): a crash
    mid-save never corrupts the previous checkpoint.  Leaves are copied
    to the host one at a time as they are written, so the host holds
    one leaf at once, not the whole tree.
  * restore(template, device=...) places each leaf on `device` (each
    template leaf's own device by default): the one-device counterpart
    of the reference's `shardings=`.  Re-meshing onto another set of
    devices waits for the port's mesh.
  * every leaf is addressed by its tree path (`tree.flatten`), so
    `strict=False` restores a template that has leaves the checkpoint
    lacks.
  * a leaf numpy cannot hold (bfloat16) raises TypeError naming its key
    rather than being cast.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import zipfile
from typing import Any

import numpy as np
import torch

from .. import tree as ptree

PyTree = Any

_NUMPY_OF = {torch.float64: np.float64, torch.float32: np.float32,
             torch.float16: np.float16, torch.int64: np.int64,
             torch.int32: np.int32, torch.int16: np.int16,
             torch.int8: np.int8, torch.uint8: np.uint8,
             torch.bool: np.bool_}


def _to_numpy(key: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NUMPY_OF:
            raise TypeError(f"checkpoint leaf {key!r} has dtype {leaf.dtype}, "
                            f"which numpy cannot hold; cast it first")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------------
    def save(self, step: int, tree: PyTree, extra: dict | None = None):
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        shapes, dtypes = {}, {}
        # what np.savez writes, a leaf at a time
        with zipfile.ZipFile(tmp / "arrays.npz", "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for path, leaf in ptree.flatten(tree):
                key = ptree.key(path)
                arr = _to_numpy(key, leaf)
                shapes[key], dtypes[key] = list(arr.shape), str(arr.dtype)
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                del arr
        manifest = {"step": step, "keys": sorted(shapes), "shapes": shapes,
                    "dtypes": dtypes, "extra": extra or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic on POSIX
        latest_tmp = self.dir / "LATEST.tmp"
        latest_tmp.write_text(final.name)
        os.replace(latest_tmp, self.dir / "LATEST")
        self._gc()
        return final

    def _steps(self) -> list[pathlib.Path]:
        """The finished step directories, oldest first."""
        return sorted(p for p in self.dir.glob("step_*")
                      if p.is_dir() and not p.name.endswith(".tmp"))

    def _gc(self):
        for p in self._steps()[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------
    def latest_step(self) -> int | None:
        """The step LATEST names, or, when LATEST points at a directory
        that is gone, the newest finished step directory."""
        ptr = self.dir / "LATEST"
        if not ptr.exists():
            return None
        name = ptr.read_text().strip()
        if not (self.dir / name).exists():
            steps = self._steps()
            if not steps:
                return None
            name = steps[-1].name
        return int(name.split("_")[1])

    def restore(self, template: PyTree, step: int | None = None, *,
                device: str | torch.device | None = None,
                strict: bool = True):
        """Restore into `template`'s structure (its tensors give each
        leaf's shape and dtype): (tree, manifest).  A tensor leaf comes
        back as a tensor on `device`, or on the template leaf's device;
        any other leaf as a numpy array."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        with np.load(d / "arrays.npz") as data:
            def one(path, leaf):
                key = ptree.key(path)
                if key not in data:
                    if strict:
                        raise KeyError(f"checkpoint missing {key}")
                    return leaf
                arr = data[key]
                if tuple(arr.shape) != tuple(np.shape(leaf)):
                    raise ValueError(f"{key}: ckpt {arr.shape} != "
                                     f"{tuple(np.shape(leaf))}")
                if not isinstance(leaf, torch.Tensor):
                    return arr.astype(np.asarray(leaf).dtype)
                if leaf.dtype not in _NUMPY_OF:
                    raise TypeError(f"template leaf {key!r} has dtype "
                                    f"{leaf.dtype}, which numpy cannot hold")
                arr = np.asarray(arr, dtype=_NUMPY_OF[leaf.dtype], order="C")
                return torch.from_numpy(arr).to(
                    leaf.device if device is None else torch.device(device))
            tree = ptree.map_with_path(one, template)
        manifest = json.loads((d / "manifest.json").read_text())
        return tree, manifest

