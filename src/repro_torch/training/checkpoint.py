"""Checkpointing with atomic writes, async save and retention — in PyTorch.

The port of ``repro.training.checkpoint``, in the reference's format, so
that a checkpoint written by either package restores in the other:

  step_000123/
    manifest.json   tree description, shapes, dtypes, sha256 per file
    <idx>.npy       one file per leaf

* **leaf order** — ``jax.tree.flatten``'s: dict keys sorted at every
  level, depth first (:func:`flatten`), with no jax.
* **atomicity** — written to ``step_N.tmp`` then renamed; a crash never
  leaves a half checkpoint that restore would pick up.
* **integrity** — per-leaf sha256 in the manifest, verified on restore.
* **async save** — leaves are fetched to the host when ``save`` is
  called; a background thread writes them, so the train loop continues.
* **dtypes** — bfloat16 leaves are stored widened to float32 with the true
  dtype recorded in the manifest; a restore casts each leaf to the dtype
  of its ``like`` leaf.
* **retention** — keep the last K steps, delete older.

A tree is nested dicts of leaves: torch tensors, numpy arrays or numbers.
:func:`restore_checkpoint` returns torch tensors, on ``device`` (default:
the CPU), in the dtypes of ``like``, whose leaves need only ``shape`` and
``dtype`` (meta tensors will do).
"""

from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "CheckpointManager"]


def flatten(tree) -> tuple[list, list]:
    """(leaves, paths) of a tree of dicts in ``jax.tree.flatten``'s order:
    keys sorted at every level, depth first."""
    leaves, paths = [], []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            leaves.append(t)
            paths.append(path)

    walk(tree, ())
    return leaves, paths


def _treedef(tree) -> str:
    """A description of the tree in the form of ``str(jax treedef)``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    return "*"


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array (bfloat16 widened to float32) and its
    true dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy(), "bfloat16"
        arr = t.cpu().numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf, order="C")
    return arr, str(arr.dtype)


def _unflatten(paths: list, leaves: list) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        if not path:
            return leaf
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def save_checkpoint(directory: str | Path, step: int, tree, *, blocking: bool = True) -> Path:
    """Serialize a tree of arrays. Returns the final path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves, _ = flatten(tree)
    # fetch to host NOW (so the caller may overwrite device tensors)
    host = [_to_host(leaf) for leaf in leaves]
    treedef = f"PyTreeDef({_treedef(tree)})"

    def _write():
        manifest = {"step": step, "treedef": treedef, "leaves": []}
        for i, (arr, dt) in enumerate(host):
            f = tmp / f"{i:05d}.npy"
            np.save(f, arr)
            digest = hashlib.sha256(f.read_bytes()).hexdigest()
            manifest["leaves"].append({"file": f.name, "shape": list(arr.shape), "dtype": dt, "sha256": digest})
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish

    if blocking:
        _write()
    else:
        threading.Thread(target=_write, daemon=True).start()
    return final


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in directory.iterdir()
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
        and (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def restore_checkpoint(directory: str | Path, step: int, like, *, device=None, verify: bool = True):
    """Restore into the structure of ``like`` (leaves with ``shape`` and
    ``dtype``): torch tensors on ``device`` (default: the CPU)."""
    path = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    leaves_like, paths = flatten(like)
    assert len(leaves_like) == len(manifest["leaves"]), (
        f"leaf count mismatch: ckpt {len(manifest['leaves'])} vs model {len(leaves_like)}"
    )
    out = []
    for meta, ref in zip(manifest["leaves"], leaves_like):
        f = path / meta["file"]
        if verify:
            digest = hashlib.sha256(f.read_bytes()).hexdigest()
            if digest != meta["sha256"]:
                raise IOError(f"checkpoint corruption in {f}: sha mismatch")
        arr = np.load(f)
        assert list(arr.shape) == list(ref.shape), (meta, tuple(ref.shape))
        out.append(torch.from_numpy(arr).to(device=device, dtype=_torch_dtype(ref.dtype)))
    return _unflatten(paths, out)


class CheckpointManager:
    """Retention + async orchestration around save/restore."""

    def __init__(self, directory: str | Path, keep: int = 3, async_save: bool = True):
        self.directory = Path(directory)
        self.keep = keep
        self.async_save = async_save

    def save(self, step: int, tree) -> None:
        save_checkpoint(self.directory, step, tree, blocking=not self.async_save)
        self._gc()

    def wait(self) -> None:
        # saves fetch tensors synchronously; writer threads are daemonic.
        # Poll until the manifest of the newest step exists.
        deadline = time.time() + 60
        while time.time() < deadline:
            s = latest_step(self.directory)
            if s is not None:
                return
            time.sleep(0.05)

    def restore_latest(self, like, *, device=None):
        s = latest_step(self.directory)
        if s is None:
            return None, None
        return s, restore_checkpoint(self.directory, s, like, device=device)

    def _gc(self) -> None:
        if not self.directory.exists():
            return
        steps = sorted(
            p for p in self.directory.iterdir() if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
        )
        for p in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(p, ignore_errors=True)
