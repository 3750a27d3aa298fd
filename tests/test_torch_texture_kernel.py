"""DPTexture's histogram kernel contract on inputs the clips never reach:
the port's plain ``texture_prox_cur_ref`` (what ``texture_prox_cur`` runs
on CPU tensors, and what ``chip_smoke.py`` holds the CUDA kernel against)
against ``texture_prox_cur_pallas`` in interpret mode.

- Images smaller than the 11×11 window (8×9, 1×40, 40×1, 1×1): every
  window reaches past the image on some side, and positions outside count
  nothing.
- A flat frame, every window one bin (counts 121), with the model all 121.
- Codes of 64 and above, which count nothing (the port's wrapper takes any
  u8 code; the Pallas kernel's sentinel 255 is such a code).

All integer, so exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_tpu.ops.pallas_texture import texture_prox_cur_pallas
from tracking_tpu_torch.ops.texture import NUM_BINS, texture_prox_cur


def _both(codes, model):
    got = texture_prox_cur(torch.from_numpy(codes), torch.from_numpy(model))
    want = texture_prox_cur_pallas(jnp.asarray(codes), jnp.asarray(model), interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]), err_msg="prox")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]), err_msg="cur")
    return got


@pytest.mark.parametrize("h,w", [(8, 9), (1, 40), (40, 1), (1, 1)])
def test_texture_smaller_than_the_window_matches_pallas(h, w):
    rng = np.random.default_rng(h * 100 + w)
    codes = rng.integers(0, NUM_BINS, (3, h, w)).astype(np.uint8)
    model = rng.integers(0, 122, (3, NUM_BINS, h, w)).astype(np.uint8)
    prox, cur = _both(codes, model)
    # a window holds at most min(h, 11) x min(w, 11) positions
    assert int(cur.sum(dim=1).max()) == min(h, 11) * min(w, 11)


def test_texture_flat_frame_with_full_model_matches_pallas():
    h, w = 24, 40
    codes = np.full((3, h, w), 37, np.uint8)
    model = np.full((3, NUM_BINS, h, w), 121, np.uint8)
    prox, cur = _both(codes, model)
    assert int(cur.max()) == 121 and int(prox.max()) == 3 * 121
    assert int(prox[5:-5, 5:-5].min()) == 3 * 121  # interior windows: one bin, full


def test_texture_codes_past_the_bins_count_nothing():
    h, w = 16, 30
    rng = np.random.default_rng(5)
    codes = rng.integers(0, NUM_BINS, (3, h, w)).astype(np.uint8)
    codes[:, rng.random((h, w)) < 0.3] = rng.integers(NUM_BINS, 256)
    model = rng.integers(0, 122, (3, NUM_BINS, h, w)).astype(np.uint8)
    prox, cur = _both(codes, model)
    assert int(cur.sum(dim=1).max()) < 121
