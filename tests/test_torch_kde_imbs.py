"""KDE and IndependentMultimodalBGS (IMBS) in the port against the JAX
package: both packages' ``run_video`` over seeded frames, with the mask,
the background image and every state leaf compared bit for bit after
every frame.

KDE at 24x32: colour with and without the colour ratios, grey, the fixed
sigma without ``SDEstimationFlag``, each past the one-time estimation and
far enough that the pair update writes into the sample ring. IMBS with
``fps=2.0`` (a sample every frame): the clip of
``tests/test_bgs_texture_imbs.py::test_imbs_builds_model_and_detects``
with a darkened patch (foreground, shadow and persistence labels), the
same with ``morphologicalFiltering``, and a clip past 50 % foreground that
halves the sampling and restores it. The port runs only the branches its
host-read flags select: the counts of its calls show each one ran, and
the bit-equal states show the JAX package took the same."""

import numpy as np
import pytest

from torch_parity import assert_step_equal, count_calls, run_both
from tracking_tpu.bgs import imbs as JIMBS
from tracking_tpu.core.registry import get_algorithm as jget
from tracking_tpu_torch import get_algorithm as tget
from tracking_tpu_torch.bgs import imbs as TIMBS
from tracking_tpu_torch.bgs import kde as TKDE
from tracking_tpu_torch.synth import make_clip

H, W = 24, 32
KDE_T = 18
KDE_CASES = [({}, 3), ({"lUseColorRatiosFlag": False}, 3), ({}, 1),
             ({"SDEstimationFlag": False, "framesToLearn": 4, "SequenceLength": 8, "TimeWindowSize": 8}, 3)]


@pytest.mark.parametrize("cfg,c", KDE_CASES, ids=["ratios", "no-ratios", "grey", "fixed-sigma"])
def test_kde_matches_reference(monkeypatch, cfg, c):
    estimates = count_calls(monkeypatch, TKDE.KDE, "_estimate")
    frames = make_clip(KDE_T, H, W, c, seed=2 + c)
    qtops = []

    def check(t, ref, got):
        assert_step_equal(t, ref, got)
        qtops.append(got[2]["qtop"].numpy().copy())

    shares, st = run_both(jget("KDE")(**cfg), tget("KDE")(**cfg), frames, check=check)
    learn = jget("KDE").Config(**cfg).framesToLearn
    assert not any(shares[:learn]) and max(shares[learn:]) > 0.0
    assert len(estimates) == int(cfg.get("SDEstimationFlag", True))  # once, at t == framesToLearn
    tb_len = st["tb"][0].shape[0]
    assert int(st["tb_count"]) >= tb_len and not np.array_equal(qtops[0], qtops[-1])  # pairs written


def _imbs_clip(shadow: bool):
    """The JAX test's clip (static background, a 20x24 object from frame
    40), 48x64x3, with a patch darkened to 0.8 from frame 45."""
    rng = np.random.default_rng(0)
    bg = rng.integers(100, 140, (1, 48, 64, 3), np.uint8)
    frames = np.tile(bg, (80, 1, 1, 1))
    frames[40:, 10:30, 20:44] = 250
    if shadow:
        frames[45:, 32:46, 2:18] = (frames[45:, 32:46, 2:18] * 0.8).astype(np.uint8)
    return frames


def _run_imbs(monkeypatch, frames, cfg):
    j_cc = count_calls(monkeypatch, JIMBS, "label_components")
    t_cc = count_calls(monkeypatch, TIMBS, "label_components")
    promotes = count_calls(monkeypatch, TIMBS.IMBS, "_promote")
    seen, scalars = [], []

    def check(t, ref, got):
        assert_step_equal(t, ref, got)
        seen.append(set(np.unique(got[0].numpy()).tolist()))
        scalars.append((bool(got[2]["model_ready"]), int(got[2]["num_samples_cur"]),
                        float(got[2]["sampling_period_cur"])))

    run_both(jget("imbs")(**cfg), tget("imbs")(**cfg), frames, check=check)
    # one labelling in the port per frame that starts with a model; the
    # JAX package traces its detection branch
    with_model = sum(r for r, _, _ in scalars[:-1])
    assert len(t_cc) == with_model > 0 and len(j_cc) >= 1
    return seen, scalars, len(promotes)


@pytest.mark.parametrize("morph", [False, True])
def test_imbs_labels(monkeypatch, morph):
    seen, scalars, promotes = _run_imbs(monkeypatch, _imbs_clip(shadow=True),
                                        {"fps": 2.0, "morphologicalFiltering": morph})
    assert set().union(*seen) == {0, 80, 180, 255}  # shadow, persistence, foreground
    assert promotes == 2 and all(s[1:] == (30, 500.0) for s in scalars)


def test_imbs_sudden_change(monkeypatch):
    """56 % of the frame turns bright after the first model: the sudden
    change rebuilds with numSamples / 3 samples at half the sampling
    period, then restores both."""
    rng = np.random.default_rng(1)
    frames = np.tile(rng.integers(100, 140, (1, H, W, 3), np.uint8), (56, 1, 1, 1))
    frames[34:, :, :18] = 240
    seen, scalars, promotes = _run_imbs(monkeypatch, frames, {"fps": 2.0})
    halved = [i for i, s in enumerate(scalars) if s[1:] == (10, 250.0)]
    assert halved and scalars[-1][1:] == (30, 500.0) and promotes >= 2
    assert 255 in set().union(*seen)
