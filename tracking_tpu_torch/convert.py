"""States to and from the JAX package's pytrees, as numpy.

An algorithm's state is a dict (SuBSENSE's and LOBSTER's colour leaves are
tuples, GMG's colour codes u32); a tracker state is the reference's
``TrackTable`` (a NamedTuple). Both become the port's
dict-of-tensors form with the same leaf names, shapes and dtypes, so both
packages can start from one state and be compared leaf by leaf. The caller
turns JAX arrays into numpy (``jax.device_get``) first: this module does
not import JAX.
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
