"""Checkpoint / resume of algorithm and tracker states, counterpart of
``tracking_tpu/core/checkpoint.py``.

A state is a tree of dicts, tuples and tensors (``bgs/base.py``), so any
state - a BGS model, the tracker table, ``{"bgs": ..., "trk": ...}`` -
saves whole with ``torch.save`` and loads back with
``torch.load(weights_only=True)``. The files are ``torch.save`` archives,
not the JAX package's orbax directories: neither package reads the other's.

    save_state(path, state)
    state = load_state(path, like=algo.init(h, w, c))
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_cpu(v) for v in tree)
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save_state(path: str, state: Any) -> None:
    """Write a state tree (tensors on any device) to ``path``, replacing a
    file that is there; the parent directory is made if missing."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(_to_cpu(state), path)


def _cast_like(restored, like, device):
    if isinstance(like, dict):
        if set(restored) != set(like):
            raise ValueError(f"checkpoint leaves {sorted(restored)} differ from the state's {sorted(like)}")
        return {k: _cast_like(restored[k], v, device) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        if len(restored) != len(like):
            raise ValueError(f"checkpoint holds {len(restored)} entries where the state has {len(like)}")
        return tuple(_cast_like(r, v, device) for r, v in zip(restored, like))
    if isinstance(like, torch.Tensor):
        if tuple(restored.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(restored.shape)} where the state has {tuple(like.shape)}")
        # a checkpoint written before a state-dtype change (FGD's f32 -> f16
        # statistics) loads into the current dtype
        return restored.to(device=like.device if device is None else device, dtype=like.dtype)
    return restored


def load_state(path: str, like: Optional[Any] = None, device=None) -> Any:
    """Read a state tree saved by :func:`save_state`. With ``like`` (e.g.
    ``algo.init(h, w, c)``) the tree must have its structure and shapes, and
    each leaf takes its dtype and, unless ``device`` is given, its device.
    Without ``like`` the leaves go to ``device``, the card by default."""
    restored = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if like is None:
        return _cast_like(restored, restored, "cuda" if device is None else device)
    return _cast_like(restored, like, device)
