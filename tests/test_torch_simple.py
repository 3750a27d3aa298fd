"""The simple algorithms (FrameDifference, StaticFrameDifference,
WeightedMovingMean, WeightedMovingVariance, AdaptiveBackgroundLearning,
AdaptiveSelectiveBackgroundLearning), SigmaDelta, shrinkBGS and MyBGS in
the port against the JAX package: both packages' ``run_video`` over 14
seeded frames at 48x64, colour and grey, with the mask, the background
image and every state leaf compared bit for bit after every frame, at the
default configs and at the configs that take the other branches
(unweighted means, a frozen background, a short learning phase, SigmaDelta's
u8 wraparound of V)."""

import numpy as np
import pytest

from torch_parity import run_both
from tracking_tpu.core.registry import get_algorithm as jget
from tracking_tpu_torch import get_algorithm as tget
from tracking_tpu_torch.synth import make_clip

T, H, W = 14, 48, 64

CASES = [
    ("FrameDifferenceBGS", {}),
    ("FrameDifferenceBGS", {"enableThreshold": False}),
    ("StaticFrameDifferenceBGS", {}),
    ("WeightedMovingMeanBGS", {}),
    ("WeightedMovingMeanBGS", {"enableWeight": False}),
    ("WeightedMovingVarianceBGS", {}),
    ("WeightedMovingVarianceBGS", {"enableWeight": False}),
    ("AdaptiveBackgroundLearning", {}),
    ("AdaptiveBackgroundLearning", {"limit": 10, "alpha": 0.2}),
    ("AdaptiveSelectiveBackgroundLearning", {}),
    ("AdaptiveSelectiveBackgroundLearning", {"learningFrames": 5, "alphaDetection": 0.3}),
    ("SigmaDeltaBGS", {}),
    ("SigmaDeltaBGS", {"ampFactor": 4, "minVar": 2}),  # V steps past 255 and wraps
    ("shrinkBGS", {}),
    ("MyBGS", {}),
]


@pytest.mark.parametrize("name,cfg", CASES, ids=[f"{n}-{'-'.join(c) or 'default'}" for n, c in CASES])
@pytest.mark.parametrize("c", [3, 1])
def test_matches_reference(name, cfg, c):
    frames = make_clip(T, H, W, c, seed=c + len(cfg))
    ja, ta = jget(name)(**cfg), tget(name)(**cfg)
    shares, _ = run_both(ja, ta, frames)
    assert max(shares) > 0.0  # something fires


def test_sigma_delta_wraps_like_the_reference():
    """ampFactor 4 from a state whose V is 250-255 on flickering pixels: V
    steps past 255 in u8, wraps to 0 and is clamped up to minVar
    (``sigma_delta.py:62``)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    frames = np.where(np.arange(6)[:, None, None, None] % 2 == 0, 0, 255).astype(np.uint8)
    frames = np.broadcast_to(frames, (6, 8, 8, 3)).copy()
    frames[:, :4] = rng.integers(0, 256, (6, 4, 8, 3), dtype=np.uint8)
    V = rng.integers(250, 256, (8, 8, 3), dtype=np.uint8)
    jstate = {"t": jnp.int32(1), "M": jnp.asarray(frames[0]), "V": jnp.asarray(V)}
    _, st = run_both(jget("SigmaDeltaBGS")(ampFactor=4), tget("SigmaDeltaBGS")(ampFactor=4), frames, jstate=jstate)
    assert (V == 255).any() and int(st["V"].min()) == 15  # a V of 255 wrapped and was clamped


def test_registry_names():
    for key, name in ((0, "FrameDifferenceBGS"), (1, "StaticFrameDifferenceBGS"), (2, "WeightedMovingMeanBGS"),
                      (3, "WeightedMovingVarianceBGS"), (6, "AdaptiveBackgroundLearning"),
                      (7, "AdaptiveSelectiveBackgroundLearning"), (35, "SigmaDeltaBGS"), ("framediff", "FrameDifferenceBGS"),
                      ("sigma-delta", "SigmaDeltaBGS"), ("shrink", "shrinkBGS"), ("mybgs", "MyBGS")):
        assert tget(key).name == name == jget(key).name
        assert tget(key).type_id == jget(key).type_id
