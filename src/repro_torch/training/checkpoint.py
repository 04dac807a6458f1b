"""Checkpointing: a tree <-> npz with a structure manifest, in the JAX
package's layout, so that a checkpoint written by either package restores in
the other.

Layout: <dir>/step_<N>/arrays.npz (leaves ``a0``, ``a1``, ... in
``jax.tree.leaves`` order) + manifest.json (``keys``: each leaf's path
string, ``step``); the newest step in a top-level LATEST.json.  The keys are
the JAX package's (``training.tree``): ``layers/0/wq`` for a parameter,
``.step`` / ``.mu/...`` / ``.nu/...`` for ``AdamWState``.  Works for params
and optimizer state alike.

The npz is written one leaf at a time (each moved to the host, written and
dropped) and read one leaf at a time, so a tree of several GB on the card
never has a second whole copy on the host.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import List, Optional

import numpy as np
import torch

from repro_torch.training import tree as T


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _keys(tree) -> List[str]:
    return [k for k, _ in T.flatten_with_paths(tree)]


def _write_npz(path: str, leaves) -> None:
    """``np.savez``'s file (stored members ``a<i>.npy``), a leaf at a
    time."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, leaf in enumerate(leaves):
            arr = _host(leaf)
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)


def save(directory: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomic save; prunes to the newest ``keep`` checkpoints."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = T.flatten_with_paths(tree)
    _write_npz(os.path.join(tmp, "arrays.npz"), [leaf for _, leaf in flat])
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"keys": [k for k, _ in flat], "step": step}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(directory, "LATEST.json"), "w") as f:
        json.dump({"latest": step}, f)
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int):
    steps = sorted(
        (int(d.split("_")[1]) for d in os.listdir(directory)
         if d.startswith("step_")), reverse=True)
    for s in steps[keep:]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    path = os.path.join(directory, "LATEST.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["latest"]


def _like(arr: np.ndarray, template):
    """``arr`` as the template leaf: a tensor on its device in its dtype,
    else an array of its dtype."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(arr).to(device=template.device,
                                        dtype=template.dtype)
    return np.asarray(arr, dtype=np.asarray(template).dtype)


def restore(directory: str, like, step: Optional[int] = None):
    """Restore into the structure of ``like`` (a template tree); each leaf
    lands on its template's device and dtype."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    keys_like = _keys(like)
    if keys_like != manifest["keys"]:
        raise ValueError("checkpoint structure mismatch:\n"
                         f"  ckpt: {manifest['keys'][:5]}...\n"
                         f"  tmpl: {keys_like[:5]}...")
    with np.load(os.path.join(d, "arrays.npz")) as data:
        restored = [_like(data[f"a{i}"], t)
                    for i, t in enumerate(T.leaves(like))]
    return T.unflatten(like, restored)

