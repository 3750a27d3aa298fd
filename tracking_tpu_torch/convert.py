"""States to and from the JAX package's pytrees, as numpy.

An algorithm's state is a dict (SuBSENSE's and LOBSTER's colour leaves are
tuples, GMG's colour codes u32); a tracker state is the reference's
``TrackTable`` (a NamedTuple). Both become the port's
dict-of-tensors form with the same leaf names, shapes and dtypes, so both
packages can start from one state and be compared leaf by leaf. The caller
turns JAX arrays into numpy (``jax.device_get``) first: this module does
not import JAX.

A batch of streams (``parallel/mesh.py``) carries its states stacked leaf
by leaf along a leading ``B``, the layout of JAX's vmapped pytree: both
conversions take it as they take one state, :func:`stack_states` builds
it and :func:`split_states` splits it into per-stream states.

A blob table (``ops/blobs.py``) crosses with :func:`blob_table_from_numpy`
and :func:`blob_table_to_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(tree, device="cuda"):
    """numpy pytree (dict / NamedTuple / tuple / array) -> port state, on
    the card unless ``device`` says otherwise."""
    if hasattr(tree, "_fields"):  # a NamedTuple such as TrackTable
        return {k: state_from_numpy(getattr(tree, k), device) for k in tree._fields}
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(state_from_numpy(v, device) for v in tree)
    arr = np.array(tree, copy=True, order="C")  # keeps 0-d arrays 0-d
    return torch.from_numpy(arr).to(device)


def state_to_numpy(state):
    """Port state -> the same structure with numpy arrays (dicts stay dicts)."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return tuple(state_to_numpy(v) for v in state)
    return state.detach().cpu().numpy()


def _map_leaves(fn, trees):
    """``fn`` over the leaves of same-structured trees (a list of them)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_leaves(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(_map_leaves(fn, [t[i] for t in trees]) for i in range(len(first)))
    return fn(trees)


def stack_states(states):
    """Per-stream states -> one state whose leaves are the streams' leaves
    stacked along a new leading axis B."""
    return _map_leaves(torch.stack, list(states))


def split_states(stacked, b: int, device=None, copy: bool = True) -> list:
    """A state stacked along B -> ``b`` per-stream states (moved to
    ``device`` where given). Each leaf is a contiguous copy of its slice,
    so that stepping a stream, which updates its state in place, leaves the
    caller's stacked tensors as they were; ``copy=False`` gives the slices
    themselves where they already lie on ``device``, for a caller that owns
    ``stacked`` (a mesh rank's own block)."""

    def check(xs):
        if xs[0].shape[0] != b:
            raise ValueError(f"a stacked state leaf of shape {tuple(xs[0].shape)} holds no {b} streams")

    _map_leaves(check, [stacked])
    return [_map_leaves(lambda xs: xs[0][i].to(device, copy=copy), [stacked]) for i in range(b)]


def blob_table_from_numpy(table, device="cuda"):
    """A JAX ``BlobTable`` whose fields are numpy arrays (or a dict of them
    by field name) -> the port's :class:`~tracking_tpu_torch.ops.blobs.BlobTable`,
    on the card unless ``device`` says otherwise."""
    from tracking_tpu_torch.ops.blobs import BlobTable

    get = table.get if isinstance(table, dict) else lambda f: getattr(table, f)
    return BlobTable(*(torch.from_numpy(np.array(get(f), copy=True, order="C")).to(device) for f in BlobTable._fields))


def blob_table_to_numpy(table) -> dict:
    """The port's ``BlobTable`` -> a dict of numpy arrays by field name, in
    field order (``tracking_tpu.ops.blobs.BlobTable(**d)`` rebuilds the JAX
    package's table)."""
    return {f: v.detach().cpu().numpy() for f, v in zip(table._fields, table)}
