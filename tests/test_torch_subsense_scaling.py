"""SuBSENSE above 153,600 px (288×544×3): the scaling branch — downsampled
motion analysis, the 5×5 neighbour spread, median ksize 11 and the
auto-reset model refresh — frame by frame against the JAX package,
bit-exact.

The refresh fires when the long- and short-term downsampled means drift 15
apart, which from a cold start takes more than 25 frames (the two rates are
equal until then). Both packages therefore start from the same mid-stream
state (converted with ``tracking_tpu_torch.convert``): frame 100 of a
stream whose long-term mean is still dark and whose short-term mean has
caught up with the scene. A global brightness jump on
frame 3 then moves the learning-rate caps."""

import jax
import jax.numpy as jnp

from torch_parity import run_both
from tracking_tpu.bgs.lbsp_family import SuBSENSE as JSuBSENSE
from tracking_tpu_torch.bgs.lbsp_family import SuBSENSE as TSuBSENSE
from tracking_tpu_torch.synth import make_clip


def test_subsense_scaling_branch_with_auto_reset():
    h, w = 288, 544
    assert h * w > 2 * 320 * 240
    scaling, use3x3, ksize, _, _ = TSuBSENSE._size_policy(h, w)
    assert scaling and not use3x3 and ksize == JSuBSENSE._size_policy(h, w)[2]
    frames = make_clip(5, h, w, 3, seed=5, brightness_jump=(3, 45))
    ja = JSuBSENSE()
    js = jax.jit(ja.warm_start)(ja.init(h, w, 3), jnp.asarray(frames[0]))
    js = dict(js, t=jnp.int32(100), ds_lt=tuple(jnp.zeros_like(d) for d in js["ds_lt"]),
              ds_st=tuple(jnp.full_like(d, 120.0) for d in js["ds_st"]))
    shares, ts = run_both(ja, TSuBSENSE(), frames, jstate=js)
    # frame 1 triggered the refresh (cooldown set to 25, then counted down)
    assert int(ts["cooldown"]) == 25 - 4
    assert float(ts["lr_lower"]) < 2.0  # the brightness jump capped the rates
    assert max(shares) > 0.0
