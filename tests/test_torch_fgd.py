"""FGD and FGDSimple (FG_0 / FG_0S) in the port against the JAX package
through both packages' ``run_video``: masks, background images and every
state leaf equal after every frame, exactly.

- On the noisy clip (sensor noise σ = 2.5), 35 frames at 48×64×3: most
  pixels change every frame, so the masks flood (94-100 % foreground) and
  the co-occurrence table fills; pixels stay foreground past
  ``absorbFrames`` = 30, so absorption fires (asserted).
- On the quiet clip (σ = 0.5) FGD's masks hold the moving objects
  (5-25 %). FGDSimple's do not: a colour first seen after frame 0 stays
  foreground until it is absorbed, and without FGD's opening these
  single-pixel novelties stay and the hole fill joins them (90 % and more).
- FGD with f32 statistics on both sides (``STAT_DTYPE``), and a grey clip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_step_equal, run_both
from tracking_tpu.bgs import fgd as JF
from tracking_tpu_torch.bgs import fgd as TF
from tracking_tpu_torch.synth import make_clip


def _run(name, frames, dtypes=None):
    """run_both for FGD / FGDSimple; returns the shares and the largest
    fg_age seen."""
    ages = []

    def check(t, ref, got):
        assert_step_equal(t, ref, got)
        ages.append(int(got[2]["fg_age"].max()))

    shares, ts = run_both(getattr(JF, name)(), getattr(TF, name)(), frames, check=check)
    return shares, max(ages), ts


@pytest.mark.parametrize("name", ["FGD", "FGDSimple"])
def test_fgd_matches_reference_on_the_noisy_clip(name):
    frames = make_clip(35, 48, 64, 3, seed=5)
    shares, age, ts = _run(name, frames)
    assert np.mean(shares[1:]) > 0.9, shares  # flooded
    assert age >= JF.FGDConfig().absorbFrames  # absorption fired
    assert ts["ct_P"].dtype == torch.float16 and int((ts["cc_P"] > 0).sum()) > 0


@pytest.mark.parametrize("name", ["FGD", "FGDSimple"])
def test_fgd_matches_reference_on_the_quiet_clip(name):
    frames = make_clip(24, 48, 64, 3, seed=6, noise=0.5)
    shares, _, _ = _run(name, frames)
    if name == "FGD":
        assert 0.02 < np.mean(shares[1:]) < 0.4, shares
    else:  # no opening: the single-pixel novelties stay, and the hole fill joins them
        assert 0.5 < np.mean(shares[1:]) < 1.0, shares


@pytest.mark.parametrize("noise", [2.5, 0.5])
def test_fgd_f32_statistics_match_reference(noise):
    saved = JF.FGD.STAT_DTYPE, TF.FGD.STAT_DTYPE
    JF.FGD.STAT_DTYPE, TF.FGD.STAT_DTYPE = jnp.float32, torch.float32
    try:
        frames = make_clip(16, 48, 64, 3, seed=7, noise=noise)
        shares, _, ts = _run("FGD", frames)
    finally:
        JF.FGD.STAT_DTYPE, TF.FGD.STAT_DTYPE = saved
    assert ts["ct_P"].dtype == torch.float32 and 0.0 < np.mean(shares) < 1.0


def test_fgd_grey_matches_reference():
    frames = make_clip(12, 48, 64, 1, seed=8, noise=0.5)
    shares, _, ts = _run("FGD", frames)
    assert ts["cc_key"].shape == (40, 2, 48, 64) and np.mean(shares[1:]) > 0.0
