"""The port's blob tracker against the JAX package's on two boxes crossing
head-on (the CCMSPF mean-shift collision path fires mid-clip): active flags,
ids, ages, candidates and blob-derived outputs bit-exact after every frame.

Kalman ``kx`` / ``kP`` and the filtered positions get rtol = atol = 1e-5:
the covariance products and ``jnp.linalg.inv`` (kalman.py:75) accumulate in
another order than torch's matmul and ``linalg.inv_ex``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal, step_both
from tracking_tpu.track.tracker import BlobTracker as JTracker
from tracking_tpu.track.tracker import TrackerConfig as JConfig
from tracking_tpu_torch.synth import crossing_masks
from tracking_tpu_torch.track.tracker import BlobTracker as TTracker



def _overlap(kx, active):
    """Pairs of active tracks whose boxes overlap (the collision test)."""
    x, y = kx[:, 0], kx[:, 1]
    w, h = np.maximum(kx[:, 2], 4.0), np.maximum(kx[:, 3], 4.0)
    ov = (np.abs(x[:, None] - x[None]) < (w[:, None] + w[None]) / 2) & (
        np.abs(y[:, None] - y[None]) < (h[:, None] + h[None]) / 2)
    ov &= active[:, None] & active[None] & ~np.eye(len(x), dtype=bool)
    return ov.any()


@pytest.mark.parametrize("tracker_type,detector", [("CCMSPF", "BD_CC"), ("CC", "BD_CC"), ("CCMSPF", "BD_Simple")])
def test_tracker_matches_reference_through_a_crossing(tracker_type, detector):
    masks = crossing_masks(24, 96, 128)
    jt = JTracker(JConfig(trackerType=tracker_type, blobDetector=detector))
    tt = TTracker(trackerType=tracker_type, blobDetector=detector)
    js, ts = jt.init(), tt.init(device="cpu")
    assert_tree_equal(jax.device_get(js)._asdict(), ts)
    collided = False
    jstep = jax.jit(jt.step)
    for t in range(masks.shape[0]):
        js, ts, jtr = step_both(jstep, tt, js, ts, masks[t])
        collided |= bool(_overlap(np.asarray(js.kx), np.asarray(js.active)))
    assert collided  # the tracks' boxes overlapped while crossing
    assert sorted(ts["ids"][ts["active"]].tolist()) == [0, 1]  # both identities survive


def test_meanshift_refine():
    """Windows clamped at every image edge; binary weights give integer
    window sums, so the centres match exactly."""
    from tracking_tpu.track.meanshift import meanshift_refine as jms1
    from tracking_tpu.track.meanshift import meanshift_refine_batch as jms
    from tracking_tpu_torch.track.meanshift import meanshift_refine as tms1
    from tracking_tpu_torch.track.meanshift import meanshift_refine_batch as tms

    rng = np.random.default_rng(8)
    weight = (rng.uniform(size=(70, 90)) < 0.3).astype(np.float32)
    weight[20:40, 30:55] = 1.0
    cy = np.array([0.0, 30.0, 69.5, 10.2, 35.7, -3.0], np.float32)
    cx = np.array([0.0, 40.0, 89.0, 85.9, 2.1, 44.0], np.float32)
    want = jax.jit(jms)(jnp.asarray(weight), jnp.asarray(cy), jnp.asarray(cx))
    got = tms(torch.from_numpy(weight), torch.from_numpy(cy), torch.from_numpy(cx))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    one = jms1(jnp.asarray(weight), jnp.float32(cy[1]), jnp.float32(cx[1]))
    got1 = tms1(torch.from_numpy(weight), torch.tensor(cy[1]), torch.tensor(cx[1]))
    for a, b in zip(one, got1):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_unported_tracker_types_raise():
    for ttype in ("MS", "MSFG", "MSPF"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TTracker(trackerType=ttype)
