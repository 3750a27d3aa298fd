"""The port's blob tracker against the JAX package's on two boxes crossing
head-on (the CCMSPF mean-shift collision path fires mid-clip): active flags,
ids, ages, candidates and blob-derived outputs bit-exact after every frame;
the MS-family trackers (MS, MSFG, MSPF) with and without the frame, and
their colour mean-shift functions, bit for bit (Kalman leaves included:
``kx`` / ``kP`` and the filtered positions are exact, the port's filter
runs in XLA:CPU's orders, ``tests/test_torch_kalman.py``)."""

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
    """The MS-family trackers (once refused here) construct, and step on a
    mask with and without a frame, grey frames too, through the kernels'
    wrappers' CPU path."""
    masks = crossing_masks(8, 64, 80)
    frames = crossing_frames(8, 64, 80)
    for ttype in MS_TYPES:
        tt = TTracker(trackerType=ttype)
        for fr in (None, frames, frames[..., 1]):
            ts = tt.init(device="cpu")
            for t in range(8):
                ts, tr = tt.step(ts, torch.from_numpy(masks[t]), None if fr is None else torch.from_numpy(fr[t]))
            assert int(ts["active"].sum()) >= 1 and tr.ids.dtype == torch.int32
            assert bool((ts["hist"][ts["active"]].sum(1) > 0).all())  # templates captured at birth
    with pytest.raises(ValueError):
        TTracker(trackerType="KCF")


MS_TYPES = ("MS", "MSFG", "MSPF")


def crossing_frames(t_len, h, w, seed=0):
    """BGR frames of ``crossing_masks``' two boxes, each with its own
    texture (red / blue dominant) over a random background; the second box
    is drawn over the first where they cross."""
    rng = np.random.default_rng(seed)
    fr = np.repeat(rng.integers(40, 200, (1, h, w, 3)).astype(np.uint8), t_len, 0)
    bh, bw = max(h // 6, 4), max(w // 9, 4)
    tex = rng.integers(0, 256, (2, bh, bw, 3))
    tex[0, ..., 2], tex[1, ..., 0] = 230, 230
    for t in range(t_len):
        boxes = ((8 + 4 * t, h // 2 - bh // 2 - 4), (w - 8 - bw - 4 * t, h // 2 - bh // 2 + 4))
        for (x, y), tx in zip(boxes, tex):
            x0, x1 = max(x, 0), max(x + bw, 0)
            fr[t, y : y + bh, x0:x1] = tx[:, x0 - x : x1 - x]
    return fr


@pytest.mark.parametrize("tracker_type", MS_TYPES)
@pytest.mark.parametrize("with_frame", [True, False], ids=["frame", "no-frame"])
def test_ms_family_matches_reference_through_a_crossing(tracker_type, with_frame):
    """MS / MSFG / MSPF on the crossing at 96x128: the whole table, the
    colour templates (captured at birth), MSPF's key chain and every output
    after each frame. The colour weights are not integers, so this holds
    the port's sum order (each window's 1,024 terms in index order, the
    template's scatter-adds in index order, its normalisation in runs of
    32) and MSPF's normals to the reference's."""
    masks = crossing_masks(24, 96, 128)
    frames = crossing_frames(24, 96, 128)
    jt = JTracker(JConfig(trackerType=tracker_type))
    tt = TTracker(trackerType=tracker_type)
    js, ts = jt.init(), tt.init(device="cpu")
    jstep = jax.jit(jt.step)
    for t in range(masks.shape[0]):
        fr = frames[t] if with_frame else None
        js, jtr = jstep(js, jnp.asarray(masks[t]), None if fr is None else jnp.asarray(fr))
        ts, ttr = tt.step(ts, torch.from_numpy(masks[t]), None if fr is None else torch.from_numpy(fr))
        assert_tree_equal(jax.device_get(js)._asdict(), ts, f"frame {t}")
        assert_tree_equal(jax.device_get(jtr)._asdict(), ttr._asdict(), f"frame {t} tracks")
    assert int(ts["active"].sum()) >= 2


def _ms_inputs(k=6, h=70, w=90, seed=3):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    frame[20:45, 30:60] = rng.integers(0, 64, (25, 30, 3))  # a dark object
    fg = (rng.uniform(size=(h, w)) < 0.2).astype(np.float32)
    fg[20:45, 30:60] = 1.0
    cy = np.array([0.0, 32.0, 69.5, 10.2, 35.7, -3.0], np.float32)[:k]
    cx = np.array([0.0, 44.0, 89.0, 85.9, 2.1, 44.0], np.float32)[:k]
    return frame, fg, cy, cx


def test_window_color_hist():
    from tracking_tpu.track.meanshift import window_color_hist as jwch
    from tracking_tpu_torch.track.meanshift import window_color_hist as twch

    frame, fg, cy, cx = _ms_inputs()
    want = jax.jit(jax.vmap(lambda y, x: jwch(jnp.asarray(frame), jnp.asarray(fg), y, x)))(cy, cx)
    got = twch(torch.from_numpy(frame), torch.from_numpy(fg), torch.from_numpy(cy), torch.from_numpy(cx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_fg", [True, False])
def test_meanshift_color_refine(use_fg):
    from tracking_tpu.track.meanshift import meanshift_color_refine as jref
    from tracking_tpu.track.meanshift import window_color_hist as jwch
    from tracking_tpu_torch.track.meanshift import meanshift_color_refine as tref

    frame, fg, cy, cx = _ms_inputs()
    f, g = jnp.asarray(frame), jnp.asarray(fg)
    hist = np.asarray(jax.jit(jax.vmap(lambda y, x: jwch(f, g, y, x)))(cy[::-1] + 3, cx[::-1] - 5))
    want = jax.jit(jax.vmap(lambda h_, y, x: jref(f, g, h_, y, x, use_fg)))(hist, cy, cx)
    got = tref(torch.from_numpy(frame), torch.from_numpy(fg), torch.from_numpy(hist.copy()), torch.from_numpy(cy),
               torch.from_numpy(cx), use_fg)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("use_fg", [True, False])
def test_particle_color_refine(use_fg):
    from tracking_tpu.track.meanshift import particle_color_refine as jpref
    from tracking_tpu.track.meanshift import window_color_hist as jwch
    from tracking_tpu_torch.ops import rng as trng
    from tracking_tpu_torch.track.meanshift import particle_color_refine as tpref

    frame, fg, cy, cx = _ms_inputs()
    f, g = jnp.asarray(frame), jnp.asarray(fg)
    hist = np.asarray(jax.jit(jax.vmap(lambda y, x: jwch(f, g, y, x)))(cy + 2, cx + 1))
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(11), len(cy)))
    want = jax.jit(jax.vmap(lambda h_, k_, y, x: jpref(f, g, h_, k_, y, x, use_fg)))(hist, keys, cy, cx)
    tkeys = torch.from_numpy(keys.copy())
    np.testing.assert_array_equal(trng.split(tkeys).numpy(), np.asarray(jax.vmap(jax.random.split)(keys)))
    got = tpref(torch.from_numpy(frame), torch.from_numpy(fg), torch.from_numpy(hist), tkeys, torch.from_numpy(cy),
                torch.from_numpy(cx), use_fg)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_whole_frame_helpers():
    """``backproject``, ``color_histogram`` and the binary-weight MSPF helper
    ``particle_refine``."""
    from tracking_tpu.track import meanshift as JMS
    from tracking_tpu_torch.track import meanshift as TMS

    frame, fg, cy, cx = _ms_inputs()
    f, g = jnp.asarray(frame), jnp.asarray(fg)
    hist = np.asarray(JMS.color_histogram(f, g))
    np.testing.assert_array_equal(TMS.color_histogram(torch.from_numpy(frame), torch.from_numpy(fg)).numpy(), hist)
    np.testing.assert_array_equal(TMS.backproject(torch.from_numpy(frame), torch.from_numpy(hist.copy())).numpy(),
                                  np.asarray(JMS.backproject(f, jnp.asarray(hist))))
    key = np.asarray(jax.random.PRNGKey(5))
    for y, x in zip(cy, cx):
        want = jax.jit(JMS.particle_refine)(g, key, y, x)
        got = TMS.particle_refine(torch.from_numpy(fg), torch.from_numpy(key.copy()), torch.tensor(y), torch.tensor(x))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
