"""The port's min-label fixed point from arbitrary initial labels
(``tracking_tpu_torch.ops.cc.label_fixpoint``: its plain version on the CPU,
the reference for the CUDA kernel) against the JAX package's XLA
``label_fixpoint`` and ``label_fixpoint_pallas`` in interpret mode, exact.

The inputs keep to what the sharded labelling feeds it: labels ordered like
row-major pixel order, ``big`` on background, and labels inside the slab's
own index window only where they are the own index of a pixel of the same
component (the XLA version's pointer jumping follows those, ``base``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_tpu.ops import cc as jcc
from tracking_tpu.ops.pallas_cc import label_fixpoint_pallas
from tracking_tpu_torch.ops import cc as tcc
from torch_parity import CC_CASES, component_min, edge_mask


def _spiral(h, w):
    m = np.zeros((h, w), bool)
    m[4, 4 : w - 10] = True
    m[4 : h - 4, w - 10] = True
    m[h - 4, 8 : w - 9] = True
    m[8 : h - 3, 8] = True
    m[8, 8 : w - 15] = True
    return m


def _masks(rng):
    """(name, fg [h, w]) at 40×70 and the ragged 70×50."""
    yield "salt", rng.uniform(size=(40, 70)) < 0.45
    yield "spiral", _spiral(40, 70)
    blocks = np.kron(rng.uniform(size=(9, 7)) < 0.5, np.ones((8, 8), bool))[:70, :50]
    yield "ragged", blocks | (rng.uniform(size=(70, 50)) < 0.2)
    yield "empty", np.zeros((40, 70), bool)
    yield "full", np.ones((40, 70), bool)


BIG = 1 << 20  # one value for every case: the Pallas kernel compiles per big
# the XLA version jitted once, with base traced: it compiles per shape and
# connectivity instead of at every eager call
_XLA_FIXPOINT = jax.jit(jcc.label_fixpoint, static_argnames=("big", "connectivity"))


def _lab0(fg, mode, rng):
    """Initial labels and (big, base) for one of the three label kinds."""
    h, w = fg.shape
    n = h * w
    big = BIG
    if mode == "iota":  # a shard three slabs down an image of 8 slabs
        base = 3 * n
        lab = base + np.arange(n).reshape(h, w)
    elif mode == "shuffled":  # strictly increasing values, all outside [base, base + n)
        base = 0
        lab = n + np.sort(rng.choice(big - 2 * n, size=n, replace=False)).reshape(h, w)
    else:  # "injected": boundary rows min-coupled with neighbours' labels
        base = 3 * n
        lab = base + np.arange(n).reshape(h, w)
        top = rng.integers(0, base, size=w)
        bot = rng.integers(base + n, 8 * n, size=w)
        take = rng.uniform(size=(2, w)) < 0.5
        lab[0] = np.where(take[0], np.minimum(lab[0], top), lab[0])
        lab[-1] = np.where(take[1], np.minimum(lab[-1], bot), lab[-1])
    return np.where(fg, lab, big).astype(np.int32), big, base


CASES = [(mode, conn) for mode in ("iota", "shuffled", "injected") for conn in (8, 4)]


@pytest.mark.parametrize("mode,conn", CASES, ids=[f"{m}-{c}conn" for m, c in CASES])
def test_label_fixpoint_matches_jax(mode, conn):
    rng = np.random.default_rng(17)
    for name, fg in _masks(rng):
        lab0, big, base = _lab0(fg, mode, rng)
        got, conv = tcc.label_fixpoint(torch.from_numpy(fg), torch.from_numpy(lab0), big, conn)
        assert conv is True
        got = got.numpy()
        want = component_min(fg, lab0, big, conn)
        np.testing.assert_array_equal(got, want, err_msg=f"{name}: vs the component-minimum oracle")
        xla, xla_conv = _XLA_FIXPOINT(jnp.asarray(fg), jnp.asarray(lab0), big=big, connectivity=conn,
                                      base=jnp.int32(base))
        assert bool(xla_conv)
        np.testing.assert_array_equal(got, np.asarray(xla), err_msg=f"{name}: vs XLA label_fixpoint")
        pal, pal_conv = label_fixpoint_pallas(jnp.asarray(fg), jnp.asarray(lab0), big, conn, interpret=True)
        assert bool(pal_conv), f"{name}: the Pallas fixed point hit its round cap"
        np.testing.assert_array_equal(got, np.asarray(pal), err_msg=f"{name}: vs label_fixpoint_pallas")


def test_label_fixpoint_wrapper_refuses_other_devices():
    """CPU tensors take the plain version; any other tensor launches the
    kernel or raises (a meta tensor raises before any build)."""
    m = torch.empty((8, 12), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tcc.label_fixpoint(m, torch.empty((8, 12), dtype=torch.int32, device="meta"), 96)
    with pytest.raises(ValueError, match="connectivity"):
        tcc.label_fixpoint(torch.zeros((4, 4), dtype=torch.bool), torch.zeros((4, 4), dtype=torch.int32), 16, 6)


def test_labels_that_index_another_component():
    """Order-consistent labels that happen to be pixel indices of another
    component (here own index + 1): the XLA version's pointer jumping
    (``ops/cc.py:124-136``) follows label 6 to pixel 6, which lies in the
    other component, and returns 1 there (ROADMAP Queue 3); the Pallas
    kernel, the oracle and the port keep each component's own minimum."""
    h, w = 4, 6
    fg = np.zeros((h, w), bool)
    fg[0, 0] = fg[1, 0] = True  # one component: pixels 0 and 6
    fg[0, w - 1] = True  # another: pixel 5 alone, label 6
    lab0 = np.where(fg, np.arange(h * w).reshape(h, w) + 1, BIG).astype(np.int32)
    got, _ = tcc.label_fixpoint(torch.from_numpy(fg), torch.from_numpy(lab0), BIG)
    pal, _ = label_fixpoint_pallas(jnp.asarray(fg), jnp.asarray(lab0), BIG, 8, interpret=True)
    np.testing.assert_array_equal(got.numpy(), component_min(fg, lab0, BIG, 8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
    assert got[0, w - 1] == 6


@pytest.mark.parametrize("case", CC_CASES)
@pytest.mark.parametrize("conn", [8, 4])
def test_label_fixpoint_on_edge_masks(case, conn):
    """The masks of ``test_torch_cc_edges.py`` with injected boundary rows
    (labels not ordered like the pixels' own), against the BFS oracle, the
    XLA version and the Pallas kernel."""
    fg = edge_mask(case)
    lab0, big, base = _lab0(fg, "injected", np.random.default_rng(23))
    got, conv = tcc.label_fixpoint(torch.from_numpy(fg), torch.from_numpy(lab0), big, conn)
    assert conv is True
    got = got.numpy()
    np.testing.assert_array_equal(got, component_min(fg, lab0, big, conn))
    xla, xla_conv = _XLA_FIXPOINT(jnp.asarray(fg), jnp.asarray(lab0), big=big, connectivity=conn, base=jnp.int32(base))
    assert bool(xla_conv)
    np.testing.assert_array_equal(got, np.asarray(xla))
    pal, pal_conv = label_fixpoint_pallas(jnp.asarray(fg), jnp.asarray(lab0), big, conn, interpret=True)
    assert bool(pal_conv)
    np.testing.assert_array_equal(got, np.asarray(pal))
