"""Checkpoint IO in ``perf_tpu``'s flat npz tree format.

Counterpart of ``perf_tpu/train/checkpoint.py:21-70``: one ``.npz`` of
numeric leaves whose keys are the nested dict keys joined by ``/``; lists
and tuples store ``__len__`` and a ``__seq__`` tag ("L" / "T"). No pickle.
A checkpoint written by either package loads unchanged in the other.
Leaves are NumPy arrays; torch tensors are written through ``.cpu()``.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _leaf(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(prefix: str, tree, out: dict):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(f"key {k!r} may not contain '/'")
            _flatten(f"{prefix}/{k}" if prefix else str(k), v, out)
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}/__len__"] = np.asarray(len(tree))
        out[f"{prefix}/__seq__"] = np.asarray(
            "T" if isinstance(tree, tuple) else "L")
        for i, v in enumerate(tree):
            _flatten(f"{prefix}/{i}", v, out)
    else:
        out[prefix] = _leaf(tree)


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if "__len__" in node:
            seq = [rebuild(node[str(i)]) for i in range(int(node["__len__"]))]
            return tuple(seq) if str(node["__seq__"]) == "T" else seq
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def save_checkpoint(path: str, state: dict):
    """state: nested dict/list/tuple of arrays, tensors and scalars."""
    flat: dict = {}
    _flatten("", state, flat)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    with np.load(path, allow_pickle=False) as f:
        flat = {k: f[k] for k in f.files}
    return _unflatten(flat)
