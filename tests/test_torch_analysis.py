"""The mask metrics, the FET scorer and the pre-processing filters of the
port against the JAX package, bit for bit: ``mask_similarity``,
``confusion_counts``, ``precision_recall_fscore`` and ``image_roc`` on
single masks and on a batch past 2^24 pixels (where the f32 count rounds
in XLA:CPU's order), ``roc_curve`` at 256 and 100 thresholds (JAX's
``linspace`` values), ``save_roc_file``'s text, ``fet.score_dirs`` with its
``SC/`` images and ``fet.main``'s lines, ``equalize_hist``, ``median_blur``,
``box_filter`` and ``PreProcessor.rotate``."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_tpu.analysis import fet as jfet
from tracking_tpu.analysis import metrics as JM
from tracking_tpu.ops import filters as JF
from tracking_tpu.ops.hist import equalize_hist as j_equalize
from tracking_tpu.runner.pipeline import PreProcessor as JPre
from tracking_tpu_torch.analysis import fet as tfet
from tracking_tpu_torch.analysis import metrics as TM
from tracking_tpu_torch.ops import filters as TF
from tracking_tpu_torch.ops.hist import equalize_hist as t_equalize
from tracking_tpu_torch.runner.pipeline import PreProcessor as TPre
from tracking_tpu_torch.synth import make_clip


def _same(ref, got, what=""):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.dtype == got.dtype and ref.shape == got.shape, (what, ref.dtype, got.dtype, ref.shape, got.shape)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def _masks(shape, seed, p=0.3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=shape) < p).astype(np.uint8) * 255


@pytest.mark.parametrize("shape", [(48, 64), (3, 40, 56), (17, 1024, 1024)], ids=["one", "batch", "past-2^24"])
def test_mask_metrics(shape):
    """Every metric of two random masks; 17 x 1024 x 1024 pixels is past
    2^24, where the f32 counts round in XLA:CPU's order."""
    pred, ref = _masks(shape, 1, 0.97), _masks(shape, 2, 0.98)
    jp, jr, tp, tr = jnp.asarray(pred), jnp.asarray(ref), torch.from_numpy(pred), torch.from_numpy(ref)
    _same(JM.mask_similarity(jp, jr), TM.mask_similarity(tp, tr), "similarity")
    for i, (a, b) in enumerate(zip(JM.confusion_counts(jp, jr), TM.confusion_counts(tp, tr))):
        _same(a, b, f"count {i}")
    for i, (a, b) in enumerate(zip(JM.precision_recall_fscore(jp, jr), TM.precision_recall_fscore(tp, tr))):
        _same(a, b, f"prf {i}")
    if len(shape) < 3 or shape[0] < 10:
        _same(JM.image_roc(jp, jr), TM.image_roc(tp, tr), "image_roc")
    else:
        # the union's count rounds in XLA's order, not as the exact count would
        union = (pred > 0) | (ref > 0)
        exact = int(union.sum())
        assert exact > 1 << 24 and float(TM.count_f32(torch.from_numpy(union))) != float(np.float32(exact))


def test_empty_masks():
    z = np.zeros((8, 8), np.uint8)
    _same(JM.mask_similarity(jnp.asarray(z), jnp.asarray(z)), TM.mask_similarity(torch.from_numpy(z), torch.from_numpy(z)))
    for a, b in zip(JM.precision_recall_fscore(jnp.asarray(z), jnp.asarray(z)),
                    TM.precision_recall_fscore(torch.from_numpy(z), torch.from_numpy(z))):
        _same(a, b)


@pytest.mark.parametrize("n", [256, 100, 7])
def test_roc_curve(n):
    rng = np.random.default_rng(n)
    score = rng.integers(0, 256, (40, 56), dtype=np.uint8)
    ref = _masks((40, 56), 3)
    for a, b in zip(JM.roc_curve(jnp.asarray(score), jnp.asarray(ref), n),
                    TM.roc_curve(torch.from_numpy(score), torch.from_numpy(ref), n)):
        _same(a, b, f"roc_curve {n}")


def test_roc_file(tmp_path):
    rng = np.random.default_rng(5)
    score = rng.integers(0, 256, (40, 56), dtype=np.uint8)
    ref = _masks((40, 56), 4)
    JM.save_roc_file(score, ref, str(tmp_path / "j.txt"))
    TM.save_roc_file(torch.from_numpy(score), torch.from_numpy(ref), str(tmp_path / "t.txt"))
    text = (tmp_path / "t.txt").read_text()
    assert text == (tmp_path / "j.txt").read_text() and text.count("\n") > 100
    np.testing.assert_array_equal(TM.roc_threshold_search(score, ref), JM.roc_threshold_search(score, ref))


def test_fet(tmp_path):
    """``score_dirs`` totals, rates and rows, the ``SC/`` images byte for
    byte, and ``main``'s lines."""
    import cv2

    gt, fg = tmp_path / "gt", tmp_path / "fg"
    gt.mkdir()
    fg.mkdir()
    for i in range(4):
        cv2.imwrite(str(gt / f"bin{i:06d}.png"), _masks((40, 56), 10 + i))
        cv2.imwrite(str(fg / f"bin{i:06d}.png"), _masks((40, 56), 20 + i, 0.4))
    cv2.imwrite(str(gt / "extra.png"), _masks((40, 56), 9))  # no partner: skipped
    j = jfet.score_dirs(str(gt), str(fg), str(tmp_path / "SCj"))
    t = tfet.score_dirs(str(gt), str(fg), str(tmp_path / "SCt"))
    assert t == j and len(t["rows"]) == 4
    for i in range(4):
        name = f"bin{i:06d}.png"
        assert (tmp_path / "SCt" / name).read_bytes() == (tmp_path / "SCj" / name).read_bytes()
    outs = []
    for main in (jfet.main, tfet.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(gt), str(fg)]) == 0
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and outs[0].startswith("TP=")


@pytest.mark.parametrize("shape", [(40, 56), (3, 40, 56), (24, 1)], ids=["gray", "batched", "column"])
def test_equalize_hist(shape):
    rng = np.random.default_rng(7)
    img = np.clip(rng.normal(90, 20, shape), 0, 255).astype(np.uint8)
    got = t_equalize(torch.from_numpy(img))
    _same(j_equalize(jnp.asarray(img)), got)
    _same(jax.jit(j_equalize)(jnp.asarray(img)), got)


@pytest.mark.parametrize("k", [3, 5])
def test_median_and_box(k):
    frame = make_clip(2, 40, 56, 3, seed=k)[1]
    gray = frame[..., 0]
    _same(jax.jit(lambda x: JF.median_blur(x, k))(jnp.asarray(gray)), TF.median_blur(torch.from_numpy(gray), k))
    chw = np.ascontiguousarray(frame.transpose(2, 0, 1))  # [..., H, W] with a leading channel axis
    _same(jax.jit(lambda x: JF.median_blur(x, k))(jnp.asarray(chw)), TF.median_blur(torch.from_numpy(chw), k))
    for norm in (True, False):
        _same(jax.jit(lambda x: JF.box_filter(x, k, norm))(jnp.asarray(chw)), TF.box_filter(torch.from_numpy(chw), k, norm))


@pytest.mark.parametrize("angle", [30.0, -45.0, 90.0, 7.5])
@pytest.mark.parametrize("c", [3, 1])
def test_rotate(angle, c):
    frame = make_clip(1, 40, 56, c, seed=1)[0]
    got = TPre.rotate(torch.from_numpy(frame), angle)
    _same(JPre.rotate(jnp.asarray(frame), angle), got, "eager")
    _same(jax.jit(lambda f: JPre.rotate(f, angle))(jnp.asarray(frame)), got, "jit")
