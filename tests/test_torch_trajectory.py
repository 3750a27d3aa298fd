"""The port's trajectory module (``track/trajectory.py``, numpy only)
against the JAX package's, fed the same per-frame ``Tracks``: the recorder's
CSV and YML text and their readers, and each analysis (HistP, HistPV,
HistPVS, HistSS, TrackDist, IOR) - per-frame scores of the live tracks,
abnormal flags, the end-of-run scores and the ``bta_data`` arrays, also
after a save / load round trip - all exactly equal."""

import numpy as np
import pytest

from tracking_tpu.track import trajectory as JT
from tracking_tpu.track.tracker import Tracks as JTracks
from tracking_tpu_torch.track import trajectory as TT
from tracking_tpu_torch.track.tracker import Tracks as TTracks

K, W, H = 8, 96, 64
NAMES = ("HistPVS", "HistP", "HistPV", "HistSS", "TrackDist", "IOR")


def _frames(n=40, seed=0):
    """Per-frame track tables as numpy: tracks appear, move, vanish and
    reappear under new ids; raw fields differ from the filtered ones."""
    rng = np.random.default_rng(seed)
    active = np.zeros(K, bool)
    ids = np.full(K, -1, np.int32)
    pos = rng.uniform(0, [W, H], (K, 2)).astype(np.float32)
    vel = rng.normal(0, 2.0, (K, 2)).astype(np.float32)
    next_id = 0
    out = []
    for _ in range(n):
        for k in range(K):
            if not active[k] and rng.uniform() < 0.15:
                active[k], ids[k], next_id = True, next_id, next_id + 1
            elif active[k] and rng.uniform() < 0.05:
                active[k], ids[k] = False, -1
        pos = (pos + vel + rng.normal(0, 0.5, (K, 2))).astype(np.float32)
        size = rng.uniform(4, 30, (K, 2)).astype(np.float32)
        f = dict(active=active.copy(), ids=np.where(active, ids, -1).astype(np.int32),
                 x=pos[:, 0].copy(), y=pos[:, 1].copy(), w=size[:, 0], h=size[:, 1])
        f.update(rx=f["x"] + 0.25, ry=f["y"] - 0.5, rw=f["w"] + 1, rh=f["h"])
        out.append(f)
    return out


@pytest.mark.parametrize("raw", [False, True])
def test_recorder_files(tmp_path, raw):
    jr, tr = JT.TrackRecorder(), TT.TrackRecorder()
    for i, f in enumerate(_frames()):
        jr.record(i, JTracks(**f), raw=raw)
        tr.record(i, TTracks(**f), raw=raw)
    assert tr.rows == jr.rows and len(tr.rows) > 50
    for ext, save in (("csv", "save_csv"), ("yml", "save_yml")):
        a, b = tmp_path / f"j.{ext}", tmp_path / f"t.{ext}"
        getattr(jr, save)(str(a))
        getattr(tr, save)(str(b))
        assert b.read_text() == a.read_text()
        load = "load_csv" if ext == "csv" else "load_yml"
        assert getattr(TT.TrackRecorder, load)(str(b)).rows == getattr(JT.TrackRecorder, load)(str(a)).rows


@pytest.mark.parametrize("name", NAMES)
def test_analysis_online_and_saved(tmp_path, name):
    ja, ta = JT.make_analysis(name, W, H), TT.make_analysis(name, W, H)
    jrec, trec = JT.TrackRecorder(), TT.TrackRecorder()
    for i, f in enumerate(_frames(seed=1)):
        ja.add_frame(i, JTracks(**f), raw=i % 2 == 1)
        ta.add_frame(i, TTracks(**f), raw=i % 2 == 1)
        jrec.record(i, JTracks(**f))
        trec.record(i, TTracks(**f))
        js, ts = ja.frame_scores(), ta.frame_scores()
        assert ts == js
        assert [ta.is_abnormal(s) for s in ts.values()] == [ja.is_abnormal(s) for s in js.values()]
    ja.finish()
    ta.finish()
    assert ta.abnormality(trec) == ja.abnormality(jrec)
    a, b = tmp_path / "j.npz", tmp_path / "t.npz"
    ja.save_data(str(a))
    ta.save_data(str(b))
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(zb[k], za[k])
    back = TT.make_analysis(name, W, H)
    back.load_data(str(b))
    assert back.abnormality(trec) == ja.abnormality(jrec)
    assert TT.make_analysis("None", W, H) is None
    with pytest.raises(ValueError):
        TT.make_analysis("Hist", W, H)
