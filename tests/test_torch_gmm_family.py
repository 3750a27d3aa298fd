"""DPGrimsonGMMBGS, DPZivkovicAGMMBGS and MixtureOfGaussianV2BGS in the
port against the JAX package: both packages' ``run_video`` over seeded
frames at 48x64, colour and grey, with the mask, the background image and
every state leaf compared bit for bit after every frame, at the defaults
and at configs that reach the other branches: Zivkovic's pruning (a large
alpha), MOG2's shadows (a clip whose shadow band darkens the background)
and MOG2 without the wrapper's threshold."""

import numpy as np
import pytest

from torch_parity import assert_step_equal, run_both
from tracking_tpu.core.registry import get_algorithm as jget
from tracking_tpu_torch import get_algorithm as tget
from tracking_tpu_torch.synth import make_clip

T, H, W = 14, 48, 64


def shadow_clip(c, seed=3):
    """The seeded clip with a band of rows darkened to 70 % from frame 6 on,
    moving down two rows a frame: OpenCV's shadow test (a darker copy of a
    background mode, 0.5 <= a <= 1) holds there."""
    frames = make_clip(T, H, W, c, seed=seed, n_objects=1)
    for t in range(6, T):
        y = 4 + 2 * (t - 6)
        frames[t, y : y + 10] = (frames[t, y : y + 10] * 0.7).astype(np.uint8)
    return frames


CASES = [
    ("DPGrimsonGMMBGS", {}),
    ("DPGrimsonGMMBGS", {"gaussians": 5, "alpha": 0.1}),
    ("DPZivkovicAGMMBGS", {}),
    ("MixtureOfGaussianV2BGS", {}),
    ("MixtureOfGaussianV2BGS", {"enableThreshold": False}),
    ("MixtureOfGaussianV2BGS", {"detectShadows": False, "nmixtures": 3}),
]


@pytest.mark.parametrize("name,cfg", CASES, ids=[f"{n}-{'-'.join(c) or 'default'}" for n, c in CASES])
@pytest.mark.parametrize("c", [3, 1])
def test_matches_reference(name, cfg, c):
    frames = make_clip(T, H, W, c, seed=c + len(cfg))
    shares, _ = run_both(jget(name)(**cfg), tget(name)(**cfg), frames)
    assert max(shares[1:]) > 0.0  # something fires after the first frame


@pytest.mark.parametrize("c", [3, 1])
def test_zivkovic_prunes(c):
    """alpha = 0.3 makes unmatched weights fall below alpha * 0.05 within a
    few frames, so modes are pruned (``gmm.py:325-328``): a pixel's mode
    count n drops on some frame, in both packages alike."""
    drops = []
    prev = {}

    def check(t, ref, got):
        assert_step_equal(t, ref, got)
        n = got[2]["n"].numpy()
        if "n" in prev:
            drops.append(int((n < prev["n"]).sum()))
        prev["n"] = n

    cfg = {"alpha": 0.3, "threshold": 4.0}
    frames = make_clip(T, H, W, c, seed=5)
    run_both(jget("DPZivkovicAGMMBGS")(**cfg), tget("DPZivkovicAGMMBGS")(**cfg), frames, check=check)
    assert sum(drops) > 0, drops


@pytest.mark.parametrize("threshold", [True, False])
@pytest.mark.parametrize("c", [3, 1])
def test_mog2_shadows(c, threshold):
    """The shadow band is labelled 127 in the raw mask (``enableThreshold``
    off) and becomes 255 through the wrapper's threshold at 15."""
    cfg = {"enableThreshold": threshold}
    values = set()

    def check(t, ref, got):
        assert_step_equal(t, ref, got)
        values.update(np.unique(got[0].numpy()).tolist())

    run_both(jget("mog2")(**cfg), tget("mog2")(**cfg), shadow_clip(c), check=check)
    assert values == ({0, 255} if threshold else {0, 127, 255}), values
