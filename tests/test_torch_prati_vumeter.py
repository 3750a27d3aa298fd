"""DPPratiMediodBGS and VuMeter in the port against the JAX package: both
packages' ``run_video`` over seeded frames at 48x64, colour and grey, with
the mask, the background image and every state leaf compared bit for bit
after every frame, at the defaults and at configs that reach the other
branches: Prati's ring replacing slots (``historySize=4``, sampled on every
frame and on every other frame), VuMeter with and without its filter."""

import numpy as np
import pytest

from torch_parity import assert_step_equal, run_both
from tracking_tpu.core.registry import get_algorithm as jget
from tracking_tpu_torch import get_algorithm as tget
from tracking_tpu_torch.synth import make_clip

T, H, W = 14, 48, 64

CASES = [
    ("DPPratiMediodBGS", {}),
    ("DPPratiMediodBGS", {"historySize": 4, "samplingRate": 1}),
    ("DPPratiMediodBGS", {"historySize": 4, "samplingRate": 2, "threshold": 10}),
    ("VuMeter", {}),
    ("VuMeter", {"enableFilter": False}),
    ("VuMeter", {"enableFilter": False, "binSize": 16, "alpha": 0.9, "threshold": 0.5}),
]


@pytest.mark.parametrize("name,cfg", CASES, ids=[f"{n}-{'-'.join(c) or 'default'}" for n, c in CASES])
@pytest.mark.parametrize("c", [3, 1])
def test_matches_reference(name, cfg, c):
    frames = make_clip(T, H, W, c, seed=c + len(cfg))
    masks = []

    def check(t, ref, got):
        assert_step_equal(t, ref, got)
        masks.append(got[0].numpy().copy())

    _, st = run_both(jget(name)(**cfg), tget(name)(**cfg), frames, check=check)
    fired = [bool(m.any()) for m in masks]
    if name == "VuMeter":  # empty for the model's first 5 frames, then foreground
        assert not any(fired[:4]) and any(fired[4:])
    elif cfg:  # the ring filled, then replaced slots, and the mask fired
        S, rate = cfg["historySize"], cfg["samplingRate"]
        assert int(st["count"]) == S and (T - 1 + rate - 1) // rate > S and any(fired)
    else:  # the default ring is still filling: no mask before t = historySize
        assert int(st["count"]) == 3 and not any(fired)
