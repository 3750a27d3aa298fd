"""DPEigenbackgroundBGS in the port against the JAX package: both
packages' ``run_video`` over seeded frames, past the PCA at t ==
historySize: at 24x32 at the defaults and with a short history, colour
and grey, and at 240x320 (CDnet's size, a Gram product of 230,400 terms);
at 24x32x3 for histories of 2-64 frames (MKL-DNN's kernels by S, ssteqr up
to 25, sstedc's divide and conquer from 26, the blocked ssytrd from 33,
two levels of cuts from 51, sormqr's blocks at 64; E = min(10, S), E = S
leaves a null-space component, the lift of rounding noise), and at 23x37 grey and
colour (D = 851 and 2,553, remainders 3 and 1 mod 4).
The mask, the background image and every state leaf (``basis`` included)
are compared bit for bit: the Gram product and the lift in XLA:CPU's dot
orders (``ops/contract``), LAPACK's ``ssyevd`` in jaxlib's order
(``ops/eigh``), the norms and the per-frame projection in XLA's orders
(``ops/pca``). Above 64 frames (``torch.linalg.eigh``, not ssyevd's
order) a 65-frame history is held to stated tolerances."""

import numpy as np
import pytest

from torch_parity import run_both
from tracking_tpu.core.registry import get_algorithm as jget
from tracking_tpu_torch import get_algorithm as tget
from tracking_tpu_torch.synth import make_clip

CASES = [({}, 3, 24, 32, 26), ({"historySize": 8, "embeddedDim": 4}, 3, 24, 32, 14),
         ({"historySize": 8, "embeddedDim": 4}, 1, 24, 32, 14), ({}, 3, 240, 320, 22)]


@pytest.mark.parametrize("cfg,c,h,w,T", CASES, ids=["default", "short", "short-grey", "default-240x320"])
def test_eigenbackground_matches_reference(cfg, c, h, w, T):
    frames = make_clip(T, h, w, c, seed=3)
    S = jget("eigenbackground").Config(**cfg).historySize
    shares, st = run_both(jget("eigenbackground")(**cfg), tget("eigenbackground")(**cfg), frames)
    assert not any(shares[:S]) and max(shares[S:]) > 0.0  # empty while the history fills
    assert float(st["basis"].abs().max()) > 0.0  # the basis was built


HISTORIES = [2, 4, 6, 10, 12, 16, 25, 26, 30, 32, 33, 34, 40, 51, 64]


@pytest.mark.parametrize("S", HISTORIES)
def test_eigenbackground_every_history(S):
    cfg = {"historySize": S, "embeddedDim": min(10, S)}
    frames = make_clip(S + 4, 24, 32, 3, seed=3)
    shares, st = run_both(jget("eigenbackground")(**cfg), tget("eigenbackground")(**cfg), frames)
    assert not any(shares[:S]) and float(st["basis"].abs().max()) > 0.0


@pytest.mark.parametrize("c", [1, 3], ids=["grey", "colour"])
def test_eigenbackground_odd_frame(c):
    """23x37: D mod 4 = 3 (grey) and 1 (colour), the Gram product's tail of
    rounded products and, grey, the 2-lane kernel's remainder."""
    frames = make_clip(24, 23, 37, c, seed=3)
    shares, st = run_both(jget("eigenbackground")(), tget("eigenbackground")(), frames)
    assert not any(shares[:20]) and float(st["basis"].abs().max()) > 0.0


MASK_SHARE = 0.005  # pixels whose squared error lies within rounding of 2 x threshold may flip
BG_LEVELS = 1  # a reconstruction within rounding of a .5 boundary rounds to the next level
PROJ_TOL = 1e-5  # torch.linalg.eigh's eigenvectors against ssyevd's: a few f32 ulps of each component


def test_eigenbackground_above_64_frames():
    """A 65-frame history takes ``torch.linalg.eigh`` (``ops/eigh.py``
    reproduces ssyevd up to 64 rows): the history and mean stay exact, the
    basis agrees through its sign-free projector basisᵀ·basis, the mask and
    the background within the stated bounds."""
    S = 65
    cfg = {"historySize": S, "embeddedDim": 10}
    frames = make_clip(S + 4, 24, 32, 3, seed=3)
    seen = []

    def check(t, ref, got):
        (jm, jb, js), (tm, tb, ts) = ref, got
        np.testing.assert_array_equal(ts["history"].numpy(), np.asarray(js["history"]), err_msg=f"history, frame {t}")
        np.testing.assert_array_equal(ts["mean"].numpy(), np.asarray(js["mean"]), err_msg=f"mean, frame {t}")
        jbas, tbas = np.asarray(js["basis"], np.float64), ts["basis"].numpy().astype(np.float64)
        proj = float(np.abs(jbas.T @ jbas - tbas.T @ tbas).max())
        flips = float((tm.numpy() != jm).mean())
        levels = int(np.abs(tb.numpy().astype(np.int32) - jb.astype(np.int32)).max())
        assert proj <= PROJ_TOL and flips <= MASK_SHARE and levels <= BG_LEVELS, (t, proj, flips, levels)
        seen.append(float(np.abs(tbas).max()))

    shares, _ = run_both(jget("eigenbackground")(**cfg), tget("eigenbackground")(**cfg), frames, check=check)
    assert not any(shares[:S]) and max(shares[S:]) > 0.0 and seen[-1] > 0.0
