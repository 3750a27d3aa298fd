"""Checkpoints of the port (``core/checkpoint.py``, ``torch.save`` files):
for each of the nine ported algorithms and for the tracker, 6 frames, save,
load into a fresh state, 6 more frames, equal to 12 frames without a break
(masks, tracks and every state leaf, bit for bit); GMG's u32 colour codes
and FGD's f16 planes keep their dtypes; a checkpoint of the wrong shape is
refused."""

import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal
from tracking_tpu_torch import get_algorithm
from tracking_tpu_torch.core.checkpoint import load_state, save_state
from tracking_tpu_torch.synth import crossing_masks, make_clip
from tracking_tpu_torch.track.tracker import BlobTracker

ALGOS = ("SuBSENSEBGS", "LOBSTERBGS", "subsenseShrink", "GMG", "DPTextureBGS", "MultiLayerBGS", "FGD", "FGDSimple",
         "MixtureOfGaussianV1BGS")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


@pytest.mark.parametrize("name", ALGOS)
def test_resume_equals_an_unbroken_run(tmp_path, name):
    algo = get_algorithm(name)()
    frames = torch.from_numpy(make_clip(13, 24, 40, 3, seed=2, noise=0.5 if name.startswith("FGD") else 2.5))
    st = algo.warm_start(algo.init(24, 40, 3, device="cpu"), frames[0])
    start = _clone(st)
    masks = []
    for t in range(1, 13):
        st, fg, _ = algo.step(st, frames[t])
        masks.append(fg)
        if t == 6:
            save_state(tmp_path / "half.ckpt", st)
    res = load_state(tmp_path / "half.ckpt", like=algo.init(24, 40, 3, device="cpu"))
    for t in range(7, 13):
        res, fg, _ = algo.step(res, frames[t])
        torch.testing.assert_close(fg, masks[t - 1], rtol=0, atol=0)
    assert_tree_equal(st, res)
    assert_tree_equal(start, load_state_round_trip(tmp_path, start))


def load_state_round_trip(tmp_path, state):
    save_state(tmp_path / "x" / "state.ckpt", state)  # makes the directory
    back = load_state(tmp_path / "x" / "state.ckpt", device="cpu")
    for a, b in zip(_leaves(state), _leaves(back)):
        assert a.dtype == b.dtype and a.device == b.device
    return back


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_u32_and_f16_leaves_survive(tmp_path):
    gmg = get_algorithm("GMG")()
    fgd = get_algorithm("FGD")()
    frames = torch.from_numpy(make_clip(4, 24, 40, 3, seed=1, noise=0.5))
    sg, sf = gmg.init(24, 40, 3, device="cpu"), fgd.warm_start(fgd.init(24, 40, 3, device="cpu"), frames[0])
    for t in range(1, 4):
        sg, _, _ = gmg.step(sg, frames[t])
        sf, _, _ = fgd.step(sf, frames[t])
    both = {"gmg": sg, "fgd": sf}
    back = load_state_round_trip(tmp_path, both)
    assert back["gmg"]["colors"].dtype == torch.uint32 and back["fgd"]["ct_P"].dtype == torch.float16
    assert_tree_equal(both, back)
    # a checkpoint written with f32 statistics loads into the f16 state
    f32 = dict(sf, ct_P=sf["ct_P"].to(torch.float32))
    save_state(tmp_path / "f32.ckpt", f32)
    assert load_state(tmp_path / "f32.ckpt", like=sf)["ct_P"].dtype == torch.float16
    with pytest.raises(ValueError):
        load_state(tmp_path / "f32.ckpt", like=fgd.init(24, 48, 3, device="cpu"))


@pytest.mark.parametrize("tracker_type", ["CCMSPF", "MSPF"])
def test_tracker_resume(tmp_path, tracker_type):
    """The tracker table (MSPF's key chain and templates included) through a
    checkpoint of ``{"bgs": ..., "trk": ...}`` as the app writes it."""
    masks = torch.from_numpy(crossing_masks(12, 64, 80))
    frames = torch.from_numpy(make_clip(12, 64, 80, 3, seed=3))
    tr = BlobTracker(trackerType=tracker_type)
    ts = tr.init(device="cpu")
    outs = []
    for t in range(12):
        ts, o = tr.step(ts, masks[t], frames[t])
        outs.append(o)
        if t == 5:
            save_state(tmp_path / "trk.ckpt", {"bgs": {"t": torch.zeros((), dtype=torch.int32)}, "trk": ts})
    res = load_state(tmp_path / "trk.ckpt", like={"bgs": {"t": torch.ones((), dtype=torch.int32)},
                                                  "trk": tr.init(device="cpu")})["trk"]
    for t in range(6, 12):
        res, o = tr.step(res, masks[t], frames[t])
        assert_tree_equal(outs[t]._asdict(), o._asdict())
    assert_tree_equal(ts, res)
    assert int(ts["active"].sum()) >= 1 and np.asarray(ts["key"]).dtype == np.uint32
