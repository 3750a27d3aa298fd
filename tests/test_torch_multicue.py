"""SJN_MultiCueBGS in the port against the JAX package: both packages'
``run_video`` over seeded 48x64 clips (a 24x32 reduced map, enlarged 2x),
the mask and every state leaf (the four codebooks, the reference and count
maps, t) compared bit for bit after every frame, with the capacities cut
to 4 model and 3 cache codewords (one JAX compile of ~10 s per config; the
default capacities take ~60 s and run in ``test_torch_multicue_default.py``).

The cases: the default training length through the end of training and
into detection (the capacities overflow: codewords replace the stalest);
a ghost box (an object present while the model trains leaves, and the box
it leaves behind is re-learnt); absorption of cache codewords with
``absorptionPeriod`` 3; a background clear with ``backClearPeriod`` 6.
The port's events are counted by wrapping its codebook helpers: each case
shows the branch it is about fired, and the bit-equal states show the JAX
package took the same."""

import numpy as np
import pytest

from torch_parity import run_both
from tracking_tpu.core.registry import get_algorithm as jget
from tracking_tpu_torch import get_algorithm as tget
from tracking_tpu_torch.bgs import multicue as TMC
from tracking_tpu_torch.synth import make_clip

H, W = 48, 64
SMALL = {"reducedWidth": 32, "reducedHeight": 24, "modelCapacity": 4, "cacheCapacity": 3}


def events(monkeypatch, back_clear: int):
    """Count, over a run, the pixels that absorb a cache codeword, that
    compact a model book on a background clear (``clear_num ==
    back_clear``), that append into a full book, and the ghost boxes."""
    ev = {"absorb": 0, "clear": 0, "overflow": 0, "ghost": 0}
    absorb, clear = TMC.MultiCue._absorb, TMC.MultiCue._clear
    construct, ghosts = TMC.MultiCue._construct, TMC.MultiCue._ghosts

    def _absorb(model, cache, ref, cnt, period, do):
        ev["absorb"] += int((do & (cnt >= period) & (ref >= 0) & (ref < cache["mnrl"].shape[0])).sum())
        return absorb(model, cache, ref, cnt, period, do)

    def _clear(book, clear_num, do):
        out = clear(book, clear_num, do)
        if clear_num == back_clear:
            ev["clear"] += int((do & (book["total"] >= clear_num) & (out["n"] < book["n"])).sum())
        return out

    def _construct(book, match, new_val_fn, upd_val_fn, do):
        out = construct(book, match, new_val_fn, upd_val_fn, do)
        ev["overflow"] += int((do & ~out[1] & (book["n"] == book["mnrl"].shape[0])).sum())  # appends, full
        return out

    def _ghosts(*a):
        g = ghosts(*a)
        ev["ghost"] += int(g.sum())
        return g

    for name, fn in (("_absorb", _absorb), ("_clear", _clear), ("_construct", _construct), ("_ghosts", _ghosts)):
        monkeypatch.setattr(TMC.MultiCue, name, staticmethod(fn))
    return ev


def ghost_clip(t_len: int, leave: int) -> np.ndarray:
    """The synthetic clip with a bright 16x20 block that sits still until
    frame ``leave`` and is gone after it."""
    frames = make_clip(t_len, H, W, 3, seed=9, n_objects=1)
    frames[:leave, 14:30, 20:40] = (230, 200, 40)
    return frames


CASES = {
    "train-detect": (dict(SMALL), make_clip(26, H, W, 3, seed=3), "overflow"),
    "ghost": (dict(SMALL, trainingPeriod=4), ghost_clip(14, 6), "ghost"),
    "absorb": (dict(SMALL, trainingPeriod=2, absorptionPeriod=3), make_clip(16, H, W, 3, seed=5), "absorb"),
    "back-clear": (dict(SMALL, trainingPeriod=2, backClearPeriod=6), make_clip(16, H, W, 3, seed=7), "clear"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_multicue_matches_reference(monkeypatch, case):
    cfg, frames, event = CASES[case]
    ev = events(monkeypatch, cfg.get("backClearPeriod", 300))
    shares, st = run_both(jget("SJN_MultiCueBGS")(**cfg), tget("SJN_MultiCueBGS")(**cfg), frames)
    train = cfg.get("trainingPeriod", 20) + 1
    assert not any(shares[:train]) and max(shares[train:]) > 0.0, shares
    assert int(st["t"]) == frames.shape[0]  # one frame each, plus the end of training's extra count
    assert ev[event] > 0, ev
