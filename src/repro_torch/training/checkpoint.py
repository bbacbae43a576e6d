"""Atomic checkpoints with a manifest, and resume (the reference's
`repro.training.checkpoint`, its layout and atomicity).

Layout:  <dir>/step_<N>/
             manifest.json      leaf paths, shapes, dtypes, metadata
             leaf_00000.npy ... one file per tree leaf

Writes go to ``<dir>/.tmp_step_<N>`` then ``os.replace()``: a crashed save
never shadows a complete one.  Leaves are taken in the tree's order
(`utils/tree.py`); their paths join keys and indices with "/", so
``(params, opt_state)`` is saved as ``0/<state_dict name>``,
``1/adam/master/<name>``, ``1/adam/m/...``, ``1/adam/v/...``,
``1/adam/step`` and ``1/feedback/...``, as the reference names its
tuple's leaves.  NumPy has no bfloat16: a bf16 leaf is saved as its 16-bit
pattern (int16) and recorded as "bfloat16" in the manifest, and read back
by that pattern.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.models.carry import tensor_from_numpy
from repro_torch.utils.tree import tree_paths_and_leaves, tree_unflatten


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree,
                    metadata: dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".tmp_step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": []}
    for i, (path, leaf) in enumerate(tree_paths_and_leaves(tree)):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": path, "file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like_tree):
    """Restore into a new tree of ``like_tree``'s structure (shapes
    checked, each leaf on its like leaf's device, in the saved dtype);
    returns (tree, metadata, step)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = tree_paths_and_leaves(like_tree)
    if len(like) != len(manifest["leaves"]):
        raise ValueError("checkpoint structure mismatch")
    new_leaves = []
    for (_, leaf), entry in zip(like, manifest["leaves"]):
        arr = np.load(os.path.join(path, entry["file"]))
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"shape mismatch at {entry['path']}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        if entry["dtype"] == "bfloat16":
            arr = arr.view(np.int16)
            new_leaves.append(torch.from_numpy(arr).view(torch.bfloat16)
                              .to(leaf.device))
        else:
            new_leaves.append(tensor_from_numpy(arr.astype(entry["dtype"]),
                                                leaf.device))
    tree = tree_unflatten(like_tree, new_leaves)
    return tree, manifest["metadata"], manifest["step"]
