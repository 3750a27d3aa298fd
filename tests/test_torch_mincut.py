"""The exact grid min cut (``ops/mincut.grid_mincut_sink_mask``) against the
JAX package's and the scipy max-flow oracle of ``tests/test_mincut.py``
(the nodes not reachable from the source in a maximum flow's residual).
Random capacities with LbpMrf's distribution (tr_cap = 1 − T, T in 0..8)
in both orientations (more sink than source capacity, and less), random
edge masks, and the uniform all-source and all-sink grids."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_mincut import _oracle_sink_mask
from tracking_tpu.ops.mincut import grid_mincut_sink_mask as jmincut
from tracking_tpu_torch.ops import mincut


def instance(seed: int, sink_heavy: bool, random_edges: bool):
    rng = np.random.default_rng(seed)
    H, W = 14, 18
    T = rng.integers(0, 9, (H, W))
    T[rng.integers(2, H - 2) :, :] //= 2  # coherent blobs: the cut has structure
    if not sink_heavy:
        T = np.where(rng.uniform(size=(H, W)) < 0.8, 0, T)
    tr_cap = (1 - T).astype(np.int32)
    if random_edges:
        up, left = rng.uniform(size=(2, H, W)) < 0.8
        up[0], left[:, 0] = False, False
    else:
        up = np.zeros((H, W), bool)
        up[1:, 1:] = True
        left = up
    return tr_cap, up, left


def check(tr_cap, up, left):
    want = _oracle_sink_mask(tr_cap, up, left)
    ref = np.asarray(jmincut(jnp.asarray(tr_cap), jnp.asarray(up), jnp.asarray(left)))
    mincut.reset_stats()
    got = mincut.grid_mincut_sink_mask(torch.from_numpy(tr_cap), torch.from_numpy(up), torch.from_numpy(left))
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got.numpy(), want)
    return dict(mincut.STATS)


@pytest.mark.parametrize("random_edges", [False, True], ids=["lbp-edges", "random-edges"])
@pytest.mark.parametrize("sink_heavy", [True, False], ids=["sink-heavy", "source-heavy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mincut_matches_reference_and_oracle(seed, sink_heavy, random_edges):
    tr_cap, up, left = instance(seed, sink_heavy, random_edges)
    rs, rt = np.maximum(tr_cap, 0).sum(), np.maximum(-tr_cap, 0).sum()
    assert (rt > rs) == sink_heavy  # the orientation under test
    stats = check(tr_cap, up, left)
    assert stats["drain_rounds"] >= 2 and stats["sweeps"] >= stats["drain_rounds"] + 1
    assert stats["host_reads"] == 1 + stats["drain_rounds"] + stats["sweeps"]


@pytest.mark.parametrize("tr", [1, -3], ids=["all-source", "all-sink"])
def test_mincut_uniform(tr):
    H, W = 8, 10
    has = np.zeros((H, W), bool)
    has[1:, 1:] = True
    check(np.full((H, W), tr, np.int32), has, has)
    got = mincut.grid_mincut_sink_mask(torch.full((H, W), tr, dtype=torch.int32), torch.from_numpy(has),
                                       torch.from_numpy(has))
    assert bool(got.all()) == (tr < 0) and bool(got.any()) == (tr < 0)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_line_pass_is_the_segmented_relaxation(axis, reverse):
    """One whole-line relaxation against its definition, a step at a time."""
    rng = np.random.default_rng(3 + axis + 2 * reverse)
    inf = 500
    d = np.where(rng.uniform(size=(9, 13)) < 0.2, rng.integers(0, 30, (9, 13)), inf).astype(np.int32)
    opens = rng.uniform(size=(9, 13)) < 0.85
    keys = mincut._line_keys(torch.from_numpy(opens), axis, reverse)
    got = mincut._line_pass(torch.from_numpy(d), keys, axis, reverse, inf).numpy()
    want = d.copy() if axis == 1 else d.T.copy()
    op = opens if axis == 1 else opens.T
    for row, o in zip(want, op):
        idx = range(len(row) - 2, -1, -1) if reverse else range(1, len(row))
        for i in idx:
            prev = i + 1 if reverse else i - 1
            if o[i]:
                row[i] = min(row[i], min(row[prev] + 1, inf))
    np.testing.assert_array_equal(got, want if axis == 1 else want.T)
