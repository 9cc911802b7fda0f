"""Checkpointing: params tree <-> flat ``.npz`` with slash-keyed arrays.

Counterpart of ``repro.training.checkpoint``, the same format and keys
(nested dict keys in sorted order joined by ``/``, list and tuple items
by their index), so a file written by either package loads in the other.
bf16 leaves are written as fp32 (numpy has no bf16; the widening is
exact), and ``load_checkpoint(like=...)`` gives them back their dtype.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator

import numpy as np
import torch


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = _to_numpy(tree)
    return out


def _flatten_keys(tree, prefix="") -> Iterator[str]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_keys(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_keys(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/")


def save_checkpoint(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(tree))


def load_checkpoint(path: str, like: Any = None) -> Any:
    """Load. Without ``like``, nested dicts of CPU tensors rebuilt from
    the slash keys; with ``like`` given, ``like``'s exact structure, each
    leaf on the device and in the dtype of its counterpart there."""
    with np.load(path) as f:
        data = dict(f)
    if like is None:
        root: Dict[str, Any] = {}
        for key, arr in data.items():
            parts = key.split("/")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(arr)
        return root
    keys = list(_flatten_keys(like))
    assert set(keys) == set(data), (
        "checkpoint keys mismatch: "
        f"missing={set(keys) - set(data)} extra={set(data) - set(keys)}")

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k], f"{prefix}{k}/") for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}/")
                              for i, v in enumerate(tree))
        arr = torch.from_numpy(data[prefix.rstrip("/")])
        if isinstance(tree, torch.Tensor):
            return arr.to(device=tree.device, dtype=tree.dtype)
        return arr
    return rebuild(like)
