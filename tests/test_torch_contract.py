"""The shared contraction (``tracking_tpu_torch/ops/contract.py``) and
Eigenbackground's per-frame products (``ops/pca.py``) against the XLA:CPU
dots they reproduce, bit for bit on seeded data: the resize's row
contraction where Eigen shards it over the inner dimension (240 rows,
blocks of 96 in its tree) and where it does not (720 rows, equal slices),
its column contraction (blocks of 1,024), the Gram product ``Xc @ Xc.T``
and the lift ``evecs.T @ Xc`` at the histories' shapes (24x32 frames, colour and
grey, 20 and 8 frames; 240x320 grey; the colour 240x320 history runs in
``test_torch_eigen.py``), the rules of both for every history of 2-32
frames (depths of every residue mod 16, frames of 1-16 values, the Gram
kernel's blocks and the lift's panels) and of 33-64 frames at those
depths, the norms of
``jnp.linalg.norm`` and the projection and reconstruction of the step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_tpu_torch.ops import contract as C
from tracking_tpu_torch.ops.pca import project, row_norms

torch.set_num_threads(1)  # as tests/torch_parity.py: xdist's workers share the cores

ROWDOT = jax.jit(lambda a, b: jax.lax.dot_general(a, b, (((0,), (0,)), ((), ())), precision="highest"))
COLDOT = jax.jit(lambda a, b: jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())), precision="highest"))
GRAM = jax.jit(lambda x: x @ x.T)
LIFT = jax.jit(lambda l, x: l @ x)
NORM = jax.jit(lambda x: jnp.linalg.norm(x, axis=1))
STEP = jax.jit(lambda basis, mean, flat: mean + basis.T @ (basis @ (flat - mean)))


def centred(rng, s, d):
    x = rng.integers(0, 256, (s, d)).astype(np.float32)
    return (x - (x.sum(0) * np.float32(1.0 / s)).astype(np.float32)).astype(np.float32)


def test_eigen_shard_rule():
    """Eigen's inner-dimension sharding of the resize's row contraction
    (XLA's [24, W] output over H): shards of 96 at 240-576 rows of 320-720
    columns, none at 720p and 1080p, nor for the column contraction."""
    for h, w in [(240, 320), (360, 640), (480, 640), (576, 720)]:
        assert C.eigen_shard_block(w, 24, h) == 96, (h, w)
        assert C.resize_rows_plan(h, w, 24).tree
    for h, w in [(720, 1280), (1080, 1920), (48, 64)]:
        assert C.eigen_shard_block(w, 24, h) == 0, (h, w)
    assert C.resize_rows_plan(720, 1280, 24).blocks == ((0, 240), (240, 480), (480, 720))
    assert C.resize_rows_plan(1080, 1920, 24).blocks[0] == (0, 272)


@pytest.mark.parametrize("h,w", [(240, 320), (576, 720), (720, 1280)])
def test_rows_contraction(h, w):
    """Dense weights (no band): the sharded tree and the equal slices."""
    rng = np.random.default_rng(h)
    wt = rng.standard_normal((h, 24)).astype(np.float32)
    x = rng.integers(0, 256, (h, w)).astype(np.float32)
    got = C.contract(torch.from_numpy(wt).T, torch.from_numpy(x), C.resize_rows_plan(h, w, 24))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ROWDOT(wt, x)))


@pytest.mark.parametrize("w", [320, 1280, 2560])
def test_cols_contraction(w):
    rng = np.random.default_rng(w)
    t = rng.standard_normal((24, w)).astype(np.float32)
    wc = rng.standard_normal((w, 32)).astype(np.float32)
    got = C.contract(torch.from_numpy(wc).T, torch.from_numpy(t).T, C.resize_cols_plan(w), out_t=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(COLDOT(t, wc)))


@pytest.mark.parametrize("s,d", [(20, 24 * 32 * 3), (8, 24 * 32 * 3), (8, 24 * 32), (8, 240 * 320)])
def test_gram_and_lift(s, d):
    rng = np.random.default_rng(s * d)
    xc = centred(rng, s, d)
    X = torch.from_numpy(xc)
    np.testing.assert_array_equal(C.contract(X, X.T, C.gram_plan(s, d)).numpy(), np.asarray(GRAM(xc)))
    lift = np.linalg.qr(rng.standard_normal((s, s)))[0].astype(np.float32)
    comps = C.contract(torch.from_numpy(lift), X, C.lift_plan(s, d))
    np.testing.assert_array_equal(comps.numpy(), np.asarray(LIFT(lift, xc)))
    np.testing.assert_array_equal(row_norms(comps).numpy(), np.asarray(NORM(comps.numpy())))


@pytest.mark.parametrize("d", [2000, 7000, 20000])
def test_lift_panels(d):
    """The lift's split and unsplit columns around a panel's edge."""
    rng = np.random.default_rng(d)
    for s in (20, 8):
        xc = centred(rng, s, d)
        lift = rng.standard_normal((s, s)).astype(np.float32)
        got = C.contract(torch.from_numpy(lift), torch.from_numpy(xc), C.lift_plan(s, d))
        np.testing.assert_array_equal(got.numpy(), np.asarray(LIFT(lift, xc)), err_msg=f"S={s}")


@pytest.mark.parametrize("e,d", [(10, 24 * 32 * 3), (4, 24 * 32), (10, 24 * 37), (12, 1001)])
def test_projection(e, d):
    """Whole and partial tiles of 8 rows, columns with a remainder mod 8."""
    rng = np.random.default_rng(e * d)
    basis = (rng.standard_normal((e, d)) * 0.05).astype(np.float32)
    mean = (rng.integers(0, 256, d) * 0.75).astype(np.float32)
    flat = rng.integers(0, 256, d).astype(np.float32)
    got = project(torch.from_numpy(basis), torch.from_numpy(flat - mean), torch.from_numpy(mean))
    np.testing.assert_array_equal(got.numpy(), np.asarray(STEP(basis, mean, flat)))


def _check_dots(shapes, seed):
    """The Gram product and the lift at each (S, D) of ``shapes`` against
    one jitted program holding all their dots (one compilation)."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    ls = [rng.standard_normal((sh[0], sh[0])).astype(np.float32) for sh in shapes]
    gs, lf = jax.jit(lambda xs, ls: ([x @ x.T for x in xs], [l @ x for l, x in zip(ls, xs)]))(xs, ls)
    bad = []
    for (s, d), x, l, g, q in zip(shapes, xs, ls, gs, lf):
        X = torch.from_numpy(x)
        if not np.array_equal(C.contract(X, X.T, C.gram_plan(s, d)).numpy(), np.asarray(g)):
            bad.append(("gram", s, d))
        if d > 1 and not np.array_equal(C.contract(torch.from_numpy(l), X, C.lift_plan(s, d)).numpy(), np.asarray(q)):
            bad.append(("lift", s, d))
    assert not bad, bad


@pytest.mark.parametrize("rows", [(2, 3, 4, 5, 6, 7), (8, 9, 10, 11, 12), (13, 14, 15, 16, 17), (18, 19, 20, 21, 22),
                                  (23, 24, 25, 26, 27), (28, 29, 30, 31, 32)], ids=lambda r: f"S{r[0]}-{r[-1]}")
def test_dot_rules_every_history(rows):
    """Every history S of 2-32 frames at depths 32-47 (every residue mod
    16), frames of 1-16 values (the lift in the Gram kernel's lanes) and
    89-94 (the 2-lane kernel's end at 17-24 rows); one chain past 4,096 at
    2-3 rows. (24x32x3 and 23x37 run whole in test_torch_eigen.py.)"""
    ds = list(range(1, 17)) + list(range(32, 48)) + [89, 90, 91, 93, 94]
    _check_dots([(s, d) for s in rows for d in ds + ([4099] if s <= 3 else [])], rows[0])


@pytest.mark.parametrize("rows", [(33, 37, 41, 42, 45, 48), (49, 50, 51, 52, 53, 54), (56, 57, 58, 61, 63, 64)],
                         ids=lambda r: f"S{r[0]}-{r[-1]}")
def test_dot_rules_long_histories(rows):
    """Histories of 33-64 frames at the depths of the groups above: the Gram
    kernel's 4 lanes (33-48; one chain at D in 1-3, 5, 6, 9) and one chain
    (49-64); the lift's panels of 1,024 (33-50, chains of 32,768 / w) and at
    51-64 the Gram kernel with rows and depth swapped, by D mod 64 (4 or 2
    lanes over S, or one chain; S mod 4 of 1 or 2 takes 2 lanes at D in
    17-24)."""
    ds = list(range(1, 17)) + list(range(32, 48)) + [89, 90, 91, 93, 94]
    _check_dots([(s, d) for s in rows for d in ds], rows[0])


@pytest.mark.parametrize("rows", [(4, 8, 9), (12, 16, 17), (20, 25, 32)], ids=lambda r: "S" + "-".join(map(str, r)))
def test_gram_blocks_and_lift_panels(rows):
    """Around the Gram kernel's blocks (8,192 over the 4-row groups, 4,096,
    1,024) and the lift's panels, with last panels of 1, 8 and 9 columns."""
    shapes = []
    for s in rows:
        blk, width = C.gram_block(s), C.lift_panel(s)
        shapes += [(s, d) for d in sorted({blk + 3, 2 * blk - 1, width + 1, width + 8, width + 9})]
    _check_dots(shapes, 1000 + rows[0])
