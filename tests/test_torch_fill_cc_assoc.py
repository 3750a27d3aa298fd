"""The port's plain hole-fill reachability, CC labelling, blob extraction
and greedy assignment (the references for the CUDA kernels) against the JAX
package: the Pallas kernels in interpret mode and the XLA fixed points, all
bit-exact."""

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import EDGE_CASES, assert_tree_equal, edge_mask
from tracking_tpu.ops import cc as jcc
from tracking_tpu.ops import morphology as jmorph
from tracking_tpu.ops.pallas_assoc import greedy_assign_pallas
from tracking_tpu.ops.pallas_cc import label_components_pallas
from tracking_tpu.ops.pallas_fill import flood_reach_pallas
from tracking_tpu_torch.ops import assoc as tassoc
from tracking_tpu_torch.ops import cc as tcc
from tracking_tpu_torch.ops import fill as tfill
from tracking_tpu_torch.ops import morphology as tmorph


def _fg_cases(rng, h=40, w=70):
    yield rng.uniform(size=(h, w)) < 0.3  # salt
    m = np.zeros((h, w), bool)
    m[5:25, 10:40] = True
    m[10:20, 15:35] = False  # a hole
    m[28:38, 45:65] = True
    m[30:36, 50:60] = False  # another
    yield m
    m = np.zeros((h, w), bool)  # a spiral: several propagation rounds
    m[4, 4:60] = True
    m[4:36, 60] = True
    m[36, 8:61] = True
    m[8:37, 8] = True
    m[8, 8:55] = True
    yield m
    yield np.zeros((h, w), bool)
    yield np.ones((h, w), bool)


def _seeds(shape, mode):
    s = np.zeros(shape, bool)
    if mode == "corner":
        s[0, 0] = True
    else:
        s[0, :] = s[-1, :] = s[:, 0] = s[:, -1] = True
    return s


@pytest.mark.parametrize("seed_mode", ["corner", "border"])
def test_flood_reach(seed_mode):
    rng = np.random.default_rng(3)
    for fg in _fg_cases(rng):
        bg = ~fg
        r0 = _seeds(fg.shape, seed_mode) & bg
        got = tfill.flood_reach(torch.from_numpy(bg), torch.from_numpy(r0)).numpy()
        np.testing.assert_array_equal(got, np.asarray(flood_reach_pallas(jnp.asarray(bg), jnp.asarray(r0), interpret=True)))
        np.testing.assert_array_equal(got, np.asarray(jax.jit(jmorph.reach_fixpoint)(jnp.asarray(bg), jnp.asarray(r0))))
        np.testing.assert_array_equal(tmorph.reach_fixpoint(torch.from_numpy(bg), torch.from_numpy(r0)).numpy(), got)


def _bfs_reach(bg, r0):
    h, w = bg.shape
    out = r0.copy()
    q = deque(zip(*np.nonzero(r0 & bg)))
    while q:
        y, x = q.popleft()
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            yy, xx = y + dy, x + dx
            if 0 <= yy < h and 0 <= xx < w and bg[yy, xx] and not out[yy, xx]:
                out[yy, xx] = True
                q.append((yy, xx))
    return out


def test_flood_reach_is_exact_past_the_reference_sweep_cap():
    """A serpentine corridor needs one sweep round per turn. The reference's
    XLA fixed point stops after 32 rounds (morphology.py:172) and leaves the
    far end unreached; the port computes the exact fixed point (ROADMAP
    Queue 3, round caps)."""
    turns, w = 40, 12
    fg = np.zeros((2 * turns + 1, w), bool)
    for i in range(turns):
        r = 2 * i + 1  # a wall row with a gap at alternating ends
        fg[r, :] = True
        fg[r, -1 if i % 2 == 0 else 0] = False
    bg, r0 = ~fg, _seeds(fg.shape, "corner") & ~fg
    exact = _bfs_reach(bg, r0)
    got = tfill.flood_reach(torch.from_numpy(bg), torch.from_numpy(r0)).numpy()
    np.testing.assert_array_equal(got, exact)
    capped = np.asarray(jax.jit(jmorph.reach_fixpoint)(jnp.asarray(bg), jnp.asarray(r0)))
    assert capped.sum() < exact.sum()  # the reference's documented cap


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("seed_mode", ["corner", "border"])
def test_flood_reach_ref_on_edge_masks(case, seed_mode):
    """The plain version the card holds the kernel against, on the masks
    chip_smoke.py's phase 3 feeds both: equal to a BFS and, inside their
    round caps, to JAX's XLA fixed point and Pallas kernel."""
    bg = edge_mask(case)
    r0 = _seeds(bg.shape, seed_mode) & bg
    got = tfill.flood_reach_ref(torch.from_numpy(bg), torch.from_numpy(r0)).numpy()
    np.testing.assert_array_equal(got, _bfs_reach(bg, r0))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jmorph.reach_fixpoint)(jnp.asarray(bg), jnp.asarray(r0))))
    np.testing.assert_array_equal(got, np.asarray(flood_reach_pallas(jnp.asarray(bg), jnp.asarray(r0), interpret=True)))
    if case == "comb33":
        assert (bg & ~got).any() == (seed_mode == "corner")  # the closed teeth are holes only for the corner seed


@pytest.mark.parametrize("connectivity", [8, 4])
def test_label_components(connectivity):
    rng = np.random.default_rng(connectivity)
    cases = list(_fg_cases(rng)) + [rng.uniform(size=(33, 61)) < 0.45]
    for fg in cases:
        m = (fg * 255).astype(np.uint8)
        got = tcc.label_components(torch.from_numpy(m), connectivity).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(label_components_pallas(jnp.asarray(m), connectivity=connectivity, interpret=True))
        )
        np.testing.assert_array_equal(got, np.asarray(jcc.label_components(jnp.asarray(m), connectivity)))


def test_extract_blobs_with_tied_areas():
    """Equal areas are common; both packages must order them the same way
    (lower label first), or the blob table reorders."""
    h, w = 48, 80
    m = np.zeros((h, w), np.uint8)
    for y0, x0 in ((2, 2), (2, 30), (20, 10), (20, 50), (35, 70)):
        m[y0 : y0 + 6, x0 : x0 + 5] = 255  # five blobs of area 30
    m[40:44, 2:20] = 255  # area 72
    m[30, 30] = 255  # singletons
    m[10, 75] = 255
    for max_blobs in (4, 64):
        want = jcc.extract_blobs(jnp.asarray(m), max_blobs=max_blobs)
        got = tcc.extract_blobs(torch.from_numpy(m), max_blobs=max_blobs)
        assert_tree_equal(want._asdict(), got._asdict())
    rng = np.random.default_rng(2)
    m = ((rng.uniform(size=(40, 56)) < 0.2) * 255).astype(np.uint8)  # many tied singletons and pairs
    assert_tree_equal(jcc.extract_blobs(jnp.asarray(m), max_blobs=64)._asdict(),
                      tcc.extract_blobs(torch.from_numpy(m), max_blobs=64)._asdict())


@pytest.mark.parametrize("k,b", [(32, 64), (8, 5), (5, 9), (64, 64), (1, 1), (33, 7), (1, 64), (64, 1)])
def test_greedy_assign(k, b):
    rng = np.random.default_rng(k * b)
    for trial in range(6):
        cost = (rng.integers(0, 9, (k, b)) * 0.25).astype(np.float32)  # many ties
        cost[rng.uniform(size=(k, b)) < 0.4] = 1e9
        cost[rng.integers(0, k, 2)] = 1e9  # gated rows
        if trial == 0:
            cost[:] = 1e9  # nothing to assign
        a_j, t_j = greedy_assign_pallas(jnp.asarray(cost), interpret=True)
        a_t, t_t = tassoc.greedy_assign(torch.from_numpy(cost))
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
        np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
        assert a_t.dtype == torch.int32 and t_t.dtype == torch.bool


def _structured_cost(kind, k, b, rng):
    if kind == "every cell equal":
        return np.full((k, b), 0.5, np.float32)
    if kind == "signed zeros":  # -0 and +0 compare equal: the flat index decides
        return np.where(rng.uniform(size=(k, b)) < 0.5, -0.0, 0.0).astype(np.float32)
    # every row's minimum in the lowest open column, so that each pair taken
    # moves every open row's minimum (the card's kernel rescans them all)
    return (np.arange(b)[None, :] + rng.integers(0, 4, (k, 1)) * 0.25).astype(np.float32)


@pytest.mark.parametrize("kind", ["every cell equal", "row minima in one column", "signed zeros"])
@pytest.mark.parametrize("k,b", [(32, 64), (64, 64), (1, 1), (33, 7), (1, 64), (64, 1)])
def test_greedy_assign_structured(kind, k, b):
    cost = _structured_cost(kind, k, b, np.random.default_rng(k + b))
    a_j, t_j = greedy_assign_pallas(jnp.asarray(cost), interpret=True)
    a_t, t_t = tassoc.greedy_assign(torch.from_numpy(cost))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    assert int((a_t >= 0).sum()) == min(k, b)  # nothing is gated: min(K, B) pairs
