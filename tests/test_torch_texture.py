"""DPTextureBGS (type 16) in the port against the JAX package.

- ``texture_prox_cur_ref`` (the plain version of the CUDA kernel) against
  ``texture_prox_cur_pallas`` in interpret mode, with model counts up to
  121 (a full window), on shapes that are no tile multiples.
- The whole algorithm through both packages' ``run_video``, on a frame
  wider than tall, one taller than wide (the transposed-mask update then
  freezes other pixels) and a grey one: masks and every state leaf
  bit-exact after every frame. Everything here is integer or one f32 blend
  in the reference's order, so nothing needs a tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import run_both
from tracking_tpu.bgs import texture as JT
from tracking_tpu.ops.pallas_texture import texture_prox_cur_pallas
from tracking_tpu_torch.bgs import texture as TT
from tracking_tpu_torch.ops.texture import texture_prox_cur
from tracking_tpu_torch.synth import make_clip


@pytest.mark.parametrize("shape", [(48, 64), (40, 130)])
def test_texture_prox_cur_ref_matches_pallas(shape):
    h, w = shape
    rng = np.random.default_rng(h + w)
    frame = rng.integers(0, 256, (h, w, 3), np.uint8)
    frame[h // 4 : 3 * h // 4] = 90  # a flat band: full windows in one bin
    codes = np.stack([np.asarray(JT._lbp6(jnp.asarray(frame[..., c]))) for c in range(3)])
    model = rng.integers(0, 122, (3, 64, h, w)).astype(np.uint8)
    got = texture_prox_cur(torch.from_numpy(codes), torch.from_numpy(model))
    want = texture_prox_cur_pallas(jnp.asarray(codes), jnp.asarray(model), interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]), err_msg="prox")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]), err_msg="cur")
    assert int(got[1].max()) == 121 and model.max() == 121
    np.testing.assert_array_equal(TT.lbp6(torch.from_numpy(frame[..., 1])).numpy(), codes[1])


@pytest.mark.parametrize(
    "h,w,c", [(48, 64, 3), (64, 40, 3), (48, 64, 1)], ids=["color-48x64", "color-64x40", "gray-48x64"]
)
def test_dptexture_matches_reference(h, w, c):
    frames = make_clip(11, h, w, c, seed=h + c)
    shares, ts = run_both(JT.DPTextureBGS(), TT.DPTextureBGS(), frames)
    assert 0.0 < np.mean(shares) < 0.5, shares
    assert int(ts["model"].max()) > 0
