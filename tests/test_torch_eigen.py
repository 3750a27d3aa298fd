"""DPEigenbackgroundBGS in the port against the JAX package: both
packages' ``run_video`` over seeded frames, past the PCA at t ==
historySize: at 24x32 at the defaults and with a short history, colour
and grey, and at 240x320 (CDnet's size, a Gram product of 230,400 terms).
The mask, the background image and every state leaf (``basis`` included)
are compared bit for bit: the Gram product and the lift in XLA:CPU's dot
orders (``ops/contract``), LAPACK's ``ssyevd`` in jaxlib's order
(``ops/eigh``), the norms and the per-frame projection in XLA's orders
(``ops/pca``)."""

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
