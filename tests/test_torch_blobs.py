"""The blob layer (``ops/blobs.py``) of the port against the JAX package's,
bit for bit on the CPU: ``blob_properties`` on the JAX test's scenes,
random masks (4- and 8-connected, ties in area, more components than
``max_blobs``), the empty and the full mask, other ``n_cand`` /
``hull_dirs``, an odd frame size (partial GEMV tiles and tails), a
non-integer image and 288x544 blobs whose moments pass 2**24; every
evaluator and ``moment_ellipse`` on one table; ``filter_blobs`` for every
condition and action; ``nth_blob``; ``paint_blobs``; ``xla_math.atan2``
against ``jax.jit(jnp.arctan2)``; ``convert``'s table round trip."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal
from tracking_tpu.ops import blobs as JB
from tracking_tpu.ops.cc import label_components as jlabel
from tracking_tpu_torch import convert
from tracking_tpu_torch.ops import blobs as TB
from tracking_tpu_torch.ops import xla_math


def _scene():
    """The JAX test's scene: a filled square, a disk, a thin bar."""
    m = np.zeros((96, 128), np.uint8)
    m[10:30, 10:30] = 255
    cv2.circle(m, (80, 24), 10, 255, -1)
    m[60:64, 20:100] = 255
    return m


def _rich():
    """Shapes for the evaluators: a square, a tilted ellipse, a disk, a
    diagonal bar, a blob on the border, an L, two single pixels."""
    m = np.zeros((128, 160), np.uint8)
    m[10:30, 10:30] = 255
    cv2.ellipse(m, (90, 70), (40, 14), 30.0, 0, 360, 255, -1)
    cv2.circle(m, (140, 20), 9, 255, -1)
    cv2.line(m, (10, 120), (60, 80), 255, 3)
    m[0:6, 60:90] = 255
    m[100:125, 120:124] = 255
    m[121:125, 124:150] = 255
    m[50, 5] = m[60, 150] = 255
    return m


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "scene":
        img = np.arange(96 * 128, dtype=np.float32).reshape(96, 128) % 251
        return _scene(), img, dict(max_blobs=8)
    if name == "border_square":
        m = np.zeros((32, 64), np.uint8)
        m[0:10, 0:10] = 255
        return m, None, dict(max_blobs=4)
    if name == "ellipse":
        m = np.zeros((128, 160), np.uint8)
        cv2.ellipse(m, (80, 64), (50, 20), 30.0, 0, 360, 255, -1)
        return m, None, dict(max_blobs=4)
    if name.startswith("random"):
        conn = int(name[-1])
        m = (rng.random((48, 64)) < 0.3).astype(np.uint8) * 255
        return m, rng.integers(0, 256, (48, 64), dtype=np.uint8), dict(max_blobs=16, connectivity=conn)
    if name == "empty":
        return np.zeros((24, 32), np.uint8), None, {}
    if name == "full":
        return np.full((24, 32), 255, np.uint8), rng.integers(0, 256, (24, 32), dtype=np.uint8), {}
    if name == "odd_cand_dirs":  # 37x61: tails in every product; 13 rows: a partial tile
        m = (rng.random((37, 61)) < 0.35).astype(np.uint8) * 255
        return m, rng.integers(0, 256, (37, 61), dtype=np.uint8), dict(max_blobs=13, n_cand=40, hull_dirs=12)
    if name == "float_image":  # non-integer terms: every lane sums term by term
        m = (rng.random((40, 56)) < 0.45).astype(np.uint8) * 255
        return m, (rng.random((40, 56)) * 300.0).astype(np.float32), dict(max_blobs=6, connectivity=4)
    if name == "big_moments":  # Σx², Σy², Σxy and Σimg² pass 2**24
        m = np.zeros((288, 544), np.uint8)
        m[20:260, 30:500] = 255
        return m, rng.integers(0, 256, (288, 544), dtype=np.uint8), {}
    if name == "low_band":  # cnt·y² and y·Σx past 2**24 from the first term on: an FMA rounds them once
        m = np.zeros((288, 544), np.uint8)
        m[241:, 100:401] = 255
        return m, rng.integers(0, 256, (288, 544), dtype=np.uint8), dict(max_blobs=8)
    raise KeyError(name)


CASES = ("scene", "border_square", "ellipse", "random4", "random8", "empty", "full", "odd_cand_dirs",
         "float_image", "big_moments", "low_band")


def _both(mask, img, **kw):
    j = JB.blob_properties(jnp.asarray(mask), image=None if img is None else jnp.asarray(img), **kw)
    t = TB.blob_properties(torch.from_numpy(mask), image=None if img is None else torch.from_numpy(img), **kw)
    return jax.device_get(j), t


@pytest.mark.parametrize("name", CASES)
def test_blob_properties(name):
    mask, img, kw = _case(name)
    j, t = _both(mask, img, **kw)
    assert_tree_equal(j._asdict(), t._asdict(), name)
    if name.startswith("random"):  # equal areas in the table, components left out
        n_comp = cv2.connectedComponents(mask, connectivity=kw["connectivity"])[0] - 1
        assert n_comp > kw["max_blobs"]
        assert len(set(np.asarray(j.area).tolist())) < kw["max_blobs"]
    if name == "big_moments":
        assert float(j.sumxx[0]) > 2**24 and float(j.sumxy[0]) > 2**24


@pytest.fixture(scope="module")
def rich_tables():
    """The JAX table of :func:`_rich` (with an image) as numpy, and the same
    table carried into the port."""
    m = _rich()
    img = (np.arange(128 * 160) % 241).reshape(128, 160).astype(np.uint8)
    j = jax.device_get(JB.blob_properties(jnp.asarray(m), image=jnp.asarray(img), max_blobs=12))
    return m, j, convert.blob_table_from_numpy(j, device="cpu")


EVALUATORS = sorted(n for n in dir(JB) if n.startswith("get_") and n not in ("get_moment", "get_num_blobs"))


@pytest.mark.parametrize("name", EVALUATORS + ["get_moment", "_breadth_c", "get_distance_point", "get_xy_inside_pt"])
def test_evaluator(rich_tables, name):
    _, j, t = rich_tables
    jt = JB.BlobTable(*(jnp.asarray(v) for v in j))
    if name == "get_moment":
        for p, q in ((0, 0), (1, 0), (0, 1), (2, 0), (0, 2), (1, 1), (2, 1)):
            np.testing.assert_array_equal(TB.get_moment(t, p, q).numpy(), np.asarray(JB.get_moment(jt, p, q)))
        return
    if name == "get_distance_point":
        want, got = JB.get_distance_from_point(jt, 19.5, 21.25), TB.get_distance_from_point(t, 19.5, 21.25)
    elif name == "get_xy_inside_pt":
        want, got = JB.get_xy_inside(jt, 15.0, 12.0), TB.get_xy_inside(t, 15.0, 12.0)
    else:
        want, got = getattr(JB, name)(jt), getattr(TB, name)(t)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_moment_ellipse(rich_tables):
    _, j, t = rich_tables
    want = JB.moment_ellipse(JB.BlobTable(*(jnp.asarray(v) for v in j)))
    got = TB.moment_ellipse(t)
    assert_tree_equal(tuple(np.asarray(w) for w in want), got)
    assert len(set(np.asarray(want[4]).tolist())) > 3  # 0 and angles in both halves of [0, π)


FILTERS = [(c, a) for c in range(TB.B_EQUAL, TB.B_OUTSIDE + 1) for a in (TB.B_INCLUDE, TB.B_EXCLUDE)]


@pytest.mark.parametrize("condition,action", FILTERS)
def test_filter_blobs(rich_tables, condition, action):
    _, j, t = rich_tables
    jt = JB.BlobTable(*(jnp.asarray(v) for v in j))
    low = float(np.sort(np.asarray(j.area))[-4])  # an area of the table: B_EQUAL meets it
    kept_j = JB.filter_blobs(jt, JB.get_area(jt), condition, low, 500.0, action)
    kept_t = TB.filter_blobs(t, TB.get_area(t), condition, low, 500.0, action)
    assert_tree_equal(jax.device_get(kept_j)._asdict(), kept_t._asdict())
    assert 0 < int(TB.get_num_blobs(kept_t)) <= int(TB.get_num_blobs(t))
    assert int(TB.get_num_blobs(kept_t)) == int(JB.get_num_blobs(kept_j))


def test_filter_unknown_condition(rich_tables):
    _, j, t = rich_tables
    with pytest.raises(ValueError):
        TB.filter_blobs(t, TB.get_area(t), 42, 1.0)


@pytest.mark.parametrize("which", ["largest", "smallest", "past_valid"])
def test_nth_blob(rich_tables, which):
    _, j, t = rich_tables
    jt = JB.BlobTable(*(jnp.asarray(v) for v in j))
    n_valid = int(np.asarray(j.valid).sum())
    assert n_valid < len(j.valid) - 1
    n, largest = {"largest": (0, True), "smallest": (0, False), "past_valid": (n_valid + 1, True)}[which]
    want = jax.device_get(JB.nth_blob(jt, JB.get_perimeter(jt), n, largest))
    got = TB.nth_blob(t, TB.get_perimeter(t), n, largest)
    assert_tree_equal(want._asdict(), got._asdict())
    assert bool(got.valid) == (which != "past_valid")


def test_paint_blobs(rich_tables):
    m, j, t = rich_tables
    jt = JB.BlobTable(*(jnp.asarray(v) for v in j))
    lab = np.array(jlabel(jnp.asarray(m)))
    kept_j = JB.filter_blobs(jt, JB.get_area(jt), JB.B_GREATER, 40.0)
    kept_t = TB.filter_blobs(t, TB.get_area(t), TB.B_GREATER, 40.0)
    want = np.asarray(JB.paint_blobs(jnp.asarray(lab), kept_j))
    got = TB.paint_blobs(torch.from_numpy(lab), kept_t)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < (m > 0).sum()


def _atan2_inputs(kind):
    rng = np.random.default_rng(7)
    if kind == "random":  # 2**20 pairs over 16 orders of magnitude
        n = 1 << 20
        mag = lambda: rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8, n)  # noqa: E731
        return mag().astype(np.float32), mag().astype(np.float32)
    if kind == "axes":  # a grid around both axes
        g = np.linspace(-1e-3, 1e-3, 201).astype(np.float32)
        far = np.float32([1, -1, 100, -100, 1e-20, -1e-20, 3e38, -3e38])
        a, b = np.meshgrid(g, far)
        return np.concatenate([a.ravel(), b.ravel()]), np.concatenate([b.ravel(), a.ravel()])
    sp = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 1e-45, -1e-45, 3e38, -3e38, 2.0, 0.5])
    a, b = np.meshgrid(sp, sp)
    return a.ravel(), b.ravel()


@pytest.mark.parametrize("kind", ["random", "axes", "special"])
def test_atan2(kind):
    y, x = _atan2_inputs(kind)
    want = np.asarray(jax.jit(jnp.arctan2)(y, x))
    got = xla_math.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (y[~same][:5], x[~same][:5], want[~same][:5], got[~same][:5])


def test_convert_round_trip(rich_tables):
    _, j, t = rich_tables
    back = JB.BlobTable(**convert.blob_table_to_numpy(t))
    assert_tree_equal(j._asdict(), back._asdict())
    again = convert.blob_table_from_numpy(convert.blob_table_to_numpy(t), device="cpu")
    assert_tree_equal(t._asdict(), again._asdict())
