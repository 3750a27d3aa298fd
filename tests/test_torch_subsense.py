"""The port's SuBSENSE against the JAX package's, frame by frame: both are
stepped through their ``run_video`` from the same warm start on the same
synthetic clip, and the masks, background images and every state leaf must
be bit-identical after every frame. (The 320×240-and-up scaling branch is
in test_torch_subsense_scaling.py.)"""

import numpy as np
import pytest

from torch_parity import run_both
from tracking_tpu.bgs.lbsp_family import SuBSENSE as JSuBSENSE
from tracking_tpu_torch.bgs.lbsp_family import SuBSENSE as TSuBSENSE
from tracking_tpu_torch.synth import make_clip


@pytest.mark.parametrize("c,frames_n", [(3, 16), (1, 12)], ids=["color-48x64", "gray-48x64"])
def test_subsense_matches_reference(c, frames_n):
    frames = make_clip(frames_n, 48, 64, c, seed=c)
    shares, ts = run_both(JSuBSENSE(), TSuBSENSE(), frames)
    assert 0.0 < np.mean(shares) < 0.5, shares  # real masks, neither empty nor flooded
    assert int(ts["pend_ctrl"].ne(0).sum()) > 0  # the deferred bank writes are exercised
