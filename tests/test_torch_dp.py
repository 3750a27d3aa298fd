"""The dp family (DPAdaptiveMedianBGS, DPMeanBGS, DPWrenGABGS) in the port
against the JAX package: both packages' ``run_video`` over seeded frames
at 48x64, colour and grey, with the mask, the background image and every
state leaf compared bit for bit after every frame, at the defaults and at
configs that take the other branches (the median's sign steps on every
samplingRate-th frame, a mean that weights the old model)."""

import numpy as np
import pytest

from torch_parity import assert_step_equal, run_both
from tracking_tpu.core.registry import get_algorithm as jget
from tracking_tpu_torch import get_algorithm as tget
from tracking_tpu_torch.synth import make_clip

T, H, W = 14, 48, 64

CASES = [
    ("DPAdaptiveMedianBGS", {}),
    ("DPAdaptiveMedianBGS", {"samplingRate": 2, "threshold": 10}),
    ("DPMeanBGS", {}),
    ("DPMeanBGS", {"alpha": 0.9, "threshold": 300}),
    ("DPWrenGABGS", {}),
    ("DPWrenGABGS", {"alpha": 0.3, "threshold": 4.0}),
]


@pytest.mark.parametrize("name,cfg", CASES, ids=[f"{n}-{'-'.join(c) or 'default'}" for n, c in CASES])
@pytest.mark.parametrize("c", [3, 1])
def test_matches_reference(name, cfg, c):
    frames = make_clip(T, H, W, c, seed=c + len(cfg))
    shares, _ = run_both(jget(name)(**cfg), tget(name)(**cfg), frames)
    assert max(shares) > 0.0  # something fires


@pytest.mark.parametrize("c", [3, 1])
def test_adaptive_median_steps_on_sampled_frames(c):
    """Over 3 x samplingRate frames the median moves exactly on the frames
    with t % samplingRate == 1 (``dp.py:65-73``), and both packages agree
    on each of them."""
    frames = make_clip(22, H, W, c, seed=7)
    moved = []
    prev = {}

    def check(t, ref, got):
        assert_step_equal(t, ref, got)
        med = got[2]["median"].numpy()
        if "m" in prev and not np.array_equal(med, prev["m"]):
            moved.append(t)
        prev["m"] = med

    run_both(jget("DPAdaptiveMedianBGS")(), tget("DPAdaptiveMedianBGS")(), frames, check=check)
    # frame 0 is the warm start, so the model's t runs one behind the frame
    # index: t = 1, 8, 15 are frames 2, 9, 16
    assert moved == [2, 9, 16]
