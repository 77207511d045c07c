"""Checkpoint and restart (the port of ``repro.checkpoint.manager``), in the
reference's on-disk layout, so either package reads the other's
checkpoints of float32 and int8 trees.

Layout: ``<dir>/step_<N>/``
  manifest.json   step, tree structure, leaf shapes and dtypes, and the
                  caller's ``extra`` (the data cursor for a bit-exact resume)
  shard_0.npz     the leaves as ``leaf_0, leaf_1, ...`` in the reference's
                  leaf order (``repro_torch.tree``)

A bf16 leaf is stored as its uint16 bits and named ``bfloat16`` in the
manifest's dtypes (numpy has no bf16 without ``ml_dtypes``).  Writes are
atomic: the step is written into a tmp dir, its files fsynced, and renamed;
``latest_step`` reads only complete manifests, so a crash mid-write never
hides the last good step.

A DTensor leaf is gathered whole before it is saved (every rank of its mesh
takes part); in a world of several ranks rank 0 writes and the others wait
for it.  ``load_checkpoint(..., shardings=)`` lays each restored leaf out
on the given mesh, which may differ from the one it was saved from (the
restore after an elastic resize).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..launch import sharding as sh
from ..tree import tree_leaves, tree_unflatten

_BF16 = "bfloat16"


def _treedef(tree) -> str:
    """The tree's structure written as ``jax``'s ``PyTreeDef`` prints it."""
    def walk(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
        if isinstance(node, tuple):
            inner = ", ".join(walk(x) for x in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if isinstance(node, list):
            return "[" + ", ".join(walk(x) for x in node) + "]"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = sh.full(leaf.detach()).cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _fsync(path: pathlib.Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _several_ranks() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def save_checkpoint(path, step: int, tree, *, extra: Optional[dict] = None) -> str:
    path = pathlib.Path(path)
    final = path / f"step_{step:08d}"
    pairs = [_to_numpy(x) for x in tree_leaves(tree)]
    if _several_ranks() and dist.get_rank() != 0:
        dist.barrier()          # rank 0 writes
        return str(final)
    try:
        _write(path, final, step, tree, pairs, extra)
    finally:
        if _several_ranks():
            dist.barrier()
    return str(final)


def _write(path: pathlib.Path, final: pathlib.Path, step: int, tree, pairs, extra) -> None:
    path.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=path, prefix=".tmp_"))
    try:
        leaves, dtypes = [a for a, _ in pairs], [dt for _, dt in pairs]
        np.savez(tmp / "shard_0.npz", **{f"leaf_{i}": a for i, a in enumerate(leaves)})
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "treedef": _treedef(tree),
            "shapes": [list(a.shape) for a in leaves],
            "dtypes": dtypes,
            "extra": extra or {},
            "complete": True,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        for f in ("shard_0.npz", "manifest.json"):
            _fsync(tmp / f)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync(path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(path) -> Optional[int]:
    """The newest step with a complete manifest under ``path``, or None."""
    path = pathlib.Path(path)
    if not path.exists():
        return None
    steps = []
    for d in path.iterdir():
        if d.name.startswith("step_") and (d / "manifest.json").exists():
            try:
                m = json.loads((d / "manifest.json").read_text())
                if m.get("complete"):
                    steps.append(m["step"])
            except (ValueError, KeyError):
                continue  # torn write: ignore
    return max(steps) if steps else None


def load_checkpoint(path, step: int, like_tree, *, shardings=None):
    """``(tree, extra)``: the step's leaves in the structure of ``like_tree``,
    each a tensor on the device of the leaf it replaces; with ``shardings``
    (a tree of ``launch.sharding.NamedSharding``, the current mesh's) each a
    DTensor laid out by its sharding."""
    d = pathlib.Path(path) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    like = tree_leaves(like_tree)
    if manifest["n_leaves"] != len(like):
        raise ValueError(f"{d} holds {manifest['n_leaves']} leaves, the tree has {len(like)}")
    leaves = []
    with np.load(d / "shard_0.npz") as data:
        for i, (ref, dtype) in enumerate(zip(like, manifest["dtypes"])):
            a = data[f"leaf_{i}"]
            if dtype == _BF16:
                t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a.copy())
            leaves.append(t.to(ref.device) if isinstance(ref, torch.Tensor) else t)
    tree = tree_unflatten(like_tree, leaves)
    if shardings is not None:
        tree = sh.distribute(tree, shardings)
    return tree, manifest["extra"]


@dataclasses.dataclass
class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; saves every ``every`` steps."""

    directory: str
    keep: int = 3
    every: int = 100

    def maybe_save(self, step: int, tree, *, extra=None) -> Optional[str]:
        if step % self.every != 0:
            return None
        out = save_checkpoint(self.directory, step, tree, extra=extra)
        self._gc()
        return out

    def restore_latest(self, like_tree, *, shardings=None):
        step = latest_step(self.directory)
        if step is None:
            return None, None, None
        tree, extra = load_checkpoint(self.directory, step, like_tree, shardings=shardings)
        return step, tree, extra

    def _gc(self) -> None:
        if _several_ranks() and dist.get_rank() != 0:
            return
        p = pathlib.Path(self.directory)
        steps = sorted(d for d in p.iterdir() if d.name.startswith("step_"))
        for d in steps[: -self.keep]:
            shutil.rmtree(d, ignore_errors=True)
