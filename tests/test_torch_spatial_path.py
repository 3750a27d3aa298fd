"""The row-sharded SuBSENSE + tracker pipeline of the port as a whole
(``tracking_tpu_torch.parallel.spatial``) against the JAX package: its
8-shard ``run_video_spatial_tracked`` on the 8-device CPU mesh, its
unsharded step -> track chain and its unsharded ``run_video``. Masks and
SuBSENSE states, tracker states and per-frame track positions exact, against
the JAX chains and against the port's own unsharded chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal
from tracking_tpu.bgs.lbsp_family import SuBSENSE as JSuBSENSE
from tracking_tpu.runner.scan import run_video as jrun
from tracking_tpu.track.tracker import BlobTracker as JTracker
from tracking_tpu_torch.bgs.lbsp_family import SuBSENSE as TSuBSENSE
from tracking_tpu_torch.parallel.spatial import run_video_spatial, run_video_spatial_tracked
from tracking_tpu_torch.track.tracker import BlobTracker as TTracker

# relaxed confirmation so the crossing engages within 12 frames (the knobs of
# tests/test_mesh.py's crossing case)
TKW = dict(newBlobDetectFrames=3, minBlobArea=10, maxLostFrames=5)


def _crossing_stream(h, w, t=12):
    """tests/test_mesh.py:298: two squares crossing on a clean background,
    so the CCMSPF mean-shift collision refinement engages mid-sequence."""
    frames = np.full((t, h, w, 3), 30, np.uint8)
    y = h // 2
    for i in range(1, t):
        xl = 4 + 4 * (i - 1)
        xr = w - 12 - 4 * (i - 1)
        frames[i, y - 11 : y - 3, xl : xl + 8] = 255
        frames[i, y - 4 : y + 4, xr : xr + 8] = 220
    return frames


def _spatial_stream(h, w, t=6, seed=3):
    """tests/test_mesh.py:123: one moving square over a noisy still frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, (1, h, w, 3), np.uint8)
    frames = np.repeat(base, t, axis=0)
    for i in range(t):
        frames[i, h // 4 + i : h // 4 + 8 + i, 10 + 2 * i : 24 + 2 * i] = 255
    return frames


FRAMES = _crossing_stream(64, 64)


_CHAINS = {}


def _once(key, make):
    if key not in _CHAINS:
        _CHAINS[key] = make()
    return _CHAINS[key]


def _port_bgs():
    """The port's unsharded SuBSENSE steps: (final state, masks)."""
    algo = TSuBSENSE()
    frames = torch.from_numpy(FRAMES)
    st = algo.warm_start(algo.init(64, 64, 3, device="cpu"), frames[0])
    masks = []
    for f in frames:
        st, fg, _ = algo.step(st, f)
        masks.append(fg)
    return st, torch.stack(masks)


def _port_chain(ttype):
    """The port's unsharded SuBSENSE step -> tracker step chain, the
    SuBSENSE run shared by the tracker types."""

    def make():
        st, masks = _once("port-bgs", _port_bgs)
        tracker = TTracker(trackerType=ttype, **TKW)
        ts, xs = tracker.init(device="cpu"), []
        for fg in masks:
            ts, tracks = tracker.step(ts, fg)
            xs.append(tracks.x)
        return st, ts, masks, torch.stack(xs)

    return _once(("port", ttype), make)


def _jax_bgs():
    """The JAX package's unsharded SuBSENSE steps (jitted): (state, masks)."""
    algo = JSuBSENSE()
    step = jax.jit(algo.step)
    st = jax.jit(algo.warm_start)(algo.init(64, 64, 3), jnp.asarray(FRAMES[0]))
    masks = []
    for f in FRAMES:
        st, fg, _ = step(st, jnp.asarray(f))
        masks.append(fg)
    return st, masks


def _jax_chain(ttype):
    """The JAX package's unsharded step -> track chain (jitted), the
    SuBSENSE run shared by the tracker types."""

    def make():
        st, masks = _once("jax-bgs", _jax_bgs)
        tracker = JTracker(trackerType=ttype, **TKW)
        track = jax.jit(tracker.step)
        ts, xs = tracker.init(), []
        for fg in masks:
            ts, tracks = track(ts, fg)
            xs.append(np.asarray(tracks.x))
        return jax.device_get(st), jax.device_get(ts)._asdict(), np.stack([np.asarray(m) for m in masks]), np.stack(xs)

    return _once(("jax", ttype), make)


def _check(want, got):
    """want / got: (bgs state, tracker state, masks, xs), bit for bit."""
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]), err_msg="masks")
    assert int((got[2] > 0).sum()) > 0
    assert_tree_equal({"xs": want[3]}, {"xs": got[3]})
    assert_tree_equal(want[1], got[1], "tracker")
    assert_tree_equal(want[0], got[0], "bgs")


def test_eight_shards_match_jax_sharded_pipeline():
    """8 shards of 8 rows (the post-processing's 14-row halo spans two
    neighbours): the port's pipeline against JAX's run_video_spatial_tracked
    on the 8-device mesh, and against the port's own unsharded chain."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    from tracking_tpu.parallel.mesh import make_mesh
    from tracking_tpu.parallel.spatial import run_video_spatial_tracked as j_run_tracked

    st, ts, masks, xs = j_run_tracked(JSuBSENSE(), JTracker(trackerType="CCMSPF", **TKW), jnp.asarray(FRAMES),
                                      make_mesh(8, stream=1))
    want = (jax.device_get(st), jax.device_get(ts)._asdict(), np.asarray(masks), np.asarray(xs))
    got = run_video_spatial_tracked(TSuBSENSE(), TTracker(trackerType="CCMSPF", **TKW), torch.from_numpy(FRAMES),
                                    n_shards=8)
    _check(want, got)
    _check(_port_chain("CCMSPF"), got)


@pytest.mark.parametrize(
    "ttype,pipelined,n",
    [("CC", True, 2), ("CCMSPF", False, 4), ("CCMSPF", True, 4), ("CC", False, 4), ("CCMSPF", False, 2)],
    ids=["CC-pipelined-2", "CCMSPF-4", "CCMSPF-pipelined-4", "CC-4", "CCMSPF-2"],
)
def test_shard_counts_and_pipelining_match_the_unsharded_chain(ttype, pipelined, n):
    got = run_video_spatial_tracked(TSuBSENSE(), TTracker(trackerType=ttype, **TKW), torch.from_numpy(FRAMES),
                                    n_shards=n, pipelined=pipelined)
    _check(_jax_chain(ttype), got)
    _check(_port_chain(ttype), got)


def test_motion_analysis_size_matches_jax_run_video():
    """240×320 turns SuBSENSE's downsampled motion analysis on (the gathered
    column sums); 4 shards of 60 rows against JAX's unsharded run_video."""
    frames = _spatial_stream(240, 320, t=4)
    j_state, j_masks = jrun(JSuBSENSE(), jnp.asarray(frames))
    state, masks = run_video_spatial(TSuBSENSE(), torch.from_numpy(frames), n_shards=4)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(j_masks))
    assert_tree_equal(jax.device_get(j_state), state)
    assert float(state["ds_lt"][0].max()) > 0.0  # the motion analysis ran


def test_unsupported_configurations_raise():
    """An algorithm whose step takes no ctx is refused, as the JAX package
    refuses it (``spatial.py:735-740``); a height that does not split too."""
    from tracking_tpu.bgs.simple import FrameDifference as JFrameDifference
    from tracking_tpu.parallel.mesh import make_mesh
    from tracking_tpu.parallel.spatial import run_video_spatial as j_run_spatial
    from tracking_tpu_torch.bgs.simple import FrameDifference

    frames = torch.from_numpy(FRAMES[:2])
    with pytest.raises(ValueError, match="spatial-context"):
        run_video_spatial(FrameDifference(), frames, n_shards=2)
    if len(jax.devices()) >= 2:
        with pytest.raises(ValueError, match="spatial-context"):
            j_run_spatial(JFrameDifference(), jnp.asarray(FRAMES[:2]), make_mesh(2, stream=1))
    with pytest.raises(ValueError, match="does not split"):
        run_video_spatial(TSuBSENSE(), frames, n_shards=5)
