"""Trajectory generation and online trajectory analysis, counterpart of
``tracking_tpu/track/trajectory.py`` (numpy only; this package keeps its
own copy so that it never imports the JAX package).

- ``TrackRecorder`` (BlobTrackGen YML / RawTracks, ``trackingMain.cpp:640-650``):
  per-frame track rows saved as OpenCV-``FileStorage`` YAML or CSV.
- ``TrajectoryAnalysis`` (HistP / HistPV / HistPVS), ``StartStopAnalysis``
  (HistSS), ``TrackDistAnalysis`` and ``IORAnalysis`` (BlobTrackAnalysis,
  ``trackingMain.cpp:110-121,667-677``): fed per frame (:meth:`add_frame`),
  they fold finished tracks into their histograms or templates, score the
  live tracks (:meth:`frame_scores`) and persist their model through
  ``bta_data=`` (:meth:`save_data` / :meth:`load_data`).

``record`` and ``add_frame`` take one frame's ``Tracks`` with numpy fields
(the frame loop copies each chunk's tracks to the host once). ``cv2`` is
imported only by the YML reader and writer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class TrackRecorder:
    """Accumulates (frame, id, x, y, w, h) rows; writes tracks files."""

    rows: List[tuple] = field(default_factory=list)

    def record(self, frame_idx: int, tracks, raw: bool = False) -> None:
        """raw=True records the pre-Kalman blob measurements (the
        BlobTrackPostProc=None path); default records the filtered states."""
        active = np.asarray(tracks.active)
        ids = np.asarray(tracks.ids)
        if raw:
            xs, ys = np.asarray(tracks.rx), np.asarray(tracks.ry)
            ws, hs = np.asarray(tracks.rw), np.asarray(tracks.rh)
        else:
            xs, ys = np.asarray(tracks.x), np.asarray(tracks.y)
            ws, hs = np.asarray(tracks.w), np.asarray(tracks.h)
        for k in np.nonzero(active)[0]:
            self.rows.append(
                (int(frame_idx), int(ids[k]), float(xs[k]), float(ys[k]), float(ws[k]), float(hs[k]))
            )

    def tracks_by_id(self) -> Dict[int, List[tuple]]:
        out: Dict[int, List[tuple]] = {}
        for row in self.rows:
            out.setdefault(row[1], []).append(row)
        return out

    def save_csv(self, path: str) -> None:
        """RawTracks-style output: frame,id,x,y,w,h per line."""
        with open(path, "w") as fh:
            fh.write("frame,id,x,y,w,h\n")
            for r in self.rows:
                fh.write("%d,%d,%.2f,%.2f,%.2f,%.2f\n" % r)

    def save_yml(self, path: str) -> None:
        """BlobTrackGen=YML parity: OpenCV-``CvFileStorage`` YAML written via
        ``cv2.FileStorage`` (so any CvFileStorage reader parses it), one map
        per track with FrameBegin / FrameNum and an [N, 5] trajectory matrix
        of (frame, x, y, w, h) rows. The legacy generator
        (``cvCreateModuleBlobTrackGenYML``, selected at
        ``trackingMain.cpp:640-650``) lives in OpenCV's legacy module outside
        the reference repo; this schema carries the same content in the same
        container format."""
        import cv2

        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
        for tid, rows in sorted(self.tracks_by_id().items()):
            fs.startWriteStruct(f"Track{tid:06d}", cv2.FILE_NODE_MAP)
            fs.write("FrameBegin", int(rows[0][0]))
            fs.write("FrameNum", len(rows))
            traj = np.array(
                [(f, x, y, w, h) for (f, _tid, x, y, w, h) in rows], np.float32
            )
            fs.write("Trajectory", traj)
            fs.endWriteStruct()
        fs.release()

    @classmethod
    def load_yml(cls, path: str) -> "TrackRecorder":
        """Read back a :meth:`save_yml` file (round-trip check)."""
        import cv2

        rec = cls()
        fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
        root = fs.root()
        for key in root.keys():
            node = root.getNode(key)
            tid = int(key.replace("Track", ""))
            traj = node.getNode("Trajectory").mat()
            for f, x, y, w, h in np.atleast_2d(traj):
                rec.rows.append((int(f), tid, float(x), float(y), float(w), float(h)))
        fs.release()
        rec.rows.sort(key=lambda r: (r[0], r[1]))
        return rec

    @classmethod
    def load_csv(cls, path: str) -> "TrackRecorder":
        rec = cls()
        with open(path) as fh:
            next(fh)
            for line in fh:
                f, i, x, y, w, h = line.strip().split(",")
                rec.rows.append((int(f), int(i), float(x), float(y), float(w), float(h)))
        return rec


class OnlineAnalysisBase:
    """Incremental (per-frame) trajectory-analysis protocol shared by every
    analyzer — the legacy modules are fed per frame (``AddBlob`` +
    ``Process``, consumed by the app at ``trackingMain.cpp:219-297``) and
    expose a per-track abnormality state the app draws live.

    Subclasses implement ``_fold_rows(rows)`` (incorporate one finished
    trajectory into the learned model) and ``_score_rows(rows)`` (score a —
    possibly partial — trajectory against the current model), plus
    ``_data()/_set_data()`` for the ``bta_data=`` persistence
    (``SetFileName`` → save-on-release, ``trackingMain.cpp:545-556``).
    ``abnormal_threshold`` calibrates the live "is abnormal" flag (and the
    IOR integrator's per-rule thresholding)."""

    abnormal_threshold: float = float("inf")

    def __init__(self):
        self._live: Dict[int, List[tuple]] = {}

    # -- model hooks (subclass) --------------------------------------------
    def _fold_rows(self, rows) -> None:
        raise NotImplementedError

    def _score_rows(self, rows) -> float:
        raise NotImplementedError

    def _data(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _set_data(self, data) -> None:
        raise NotImplementedError

    # -- online protocol ----------------------------------------------------
    def add_frame(self, frame_idx: int, tracks, raw: bool = False) -> None:
        """Feed one frame's track table; folds tracks that disappeared this
        frame into the model (the legacy analyzers learn from completed
        trajectories)."""
        active = np.asarray(tracks.active)
        ids = np.asarray(tracks.ids)
        if raw:
            xs, ys = np.asarray(tracks.rx), np.asarray(tracks.ry)
            ws, hs = np.asarray(tracks.rw), np.asarray(tracks.rh)
        else:
            xs, ys = np.asarray(tracks.x), np.asarray(tracks.y)
            ws, hs = np.asarray(tracks.w), np.asarray(tracks.h)
        seen = set()
        for k in np.nonzero(active)[0]:
            tid = int(ids[k])
            seen.add(tid)
            self._live.setdefault(tid, []).append(
                (int(frame_idx), tid, float(xs[k]), float(ys[k]), float(ws[k]), float(hs[k]))
            )
        for tid in [t for t in self._live if t not in seen]:
            self._fold_rows(self._live.pop(tid))

    def finish(self) -> None:
        """End of run: fold the still-live tracks (legacy Release path)."""
        for rows in self._live.values():
            self._fold_rows(rows)
        self._live = {}

    def frame_scores(self) -> Dict[int, float]:
        """Current per-track abnormality of the LIVE tracks vs the model."""
        return {tid: self._score_rows(rows) for tid, rows in self._live.items()}

    def is_abnormal(self, score: float) -> bool:
        return score >= self.abnormal_threshold

    # -- offline protocol (whole-run batch; used by tests/CLI summary) ------
    def update(self, recorder: "TrackRecorder") -> None:
        for rows in recorder.tracks_by_id().values():
            self._fold_rows(rows)

    def abnormality(self, recorder: "TrackRecorder") -> Dict[int, float]:
        return {
            tid: self._score_rows(rows)
            for tid, rows in recorder.tracks_by_id().items()
        }

    # -- bta_data persistence ----------------------------------------------
    def save_data(self, path: str) -> None:
        # file-handle form: np.savez(path) would append ".npz" to the name
        with open(path, "wb") as fh:
            np.savez(fh, **self._data())

    def load_data(self, path: str) -> None:
        with np.load(path) as z:
            self._set_data(dict(z))


class TrajectoryAnalysis(OnlineAnalysisBase):
    """Histogram-based trajectory analysis (the legacy HistP/HistPV/HistPVS
    family, ``cvCreateModuleBlobTrackAnalysisHist*``).

    Builds 2-D position / velocity / size histograms over all observed track
    states; a track's abnormality score is the mean negative log-frequency of
    its states — low-probability trajectories score high, mirroring the
    legacy analyzers' "abnormal track" flag. The P/PV/PVS variants enable the
    position, +velocity, +size (state) feature sets respectively
    (``trackingMain.cpp:110-121``)."""

    abnormal_threshold = 9.0  # nll per feature set; rare-bin states exceed it

    def __init__(
        self,
        frame_w: int,
        frame_h: int,
        pos_bins: int = 16,
        vel_bins: int = 9,
        size_bins: int = 9,
        use_vel: bool = True,
        use_size: bool = False,
    ):
        super().__init__()
        self.frame_w, self.frame_h = frame_w, frame_h
        self.pos_bins, self.vel_bins, self.size_bins = pos_bins, vel_bins, size_bins
        self.use_vel, self.use_size = use_vel, use_size
        self.pos_hist = np.zeros((pos_bins, pos_bins), np.float64)
        self.vel_hist = np.zeros((vel_bins, vel_bins), np.float64)
        self.size_hist = np.zeros((size_bins, size_bins), np.float64)
        self.total = 0

    @classmethod
    def hist_p(cls, frame_w, frame_h):
        return cls(frame_w, frame_h, use_vel=False, use_size=False)

    @classmethod
    def hist_pv(cls, frame_w, frame_h):
        return cls(frame_w, frame_h, use_vel=True, use_size=False)

    @classmethod
    def hist_pvs(cls, frame_w, frame_h):
        return cls(frame_w, frame_h, use_vel=True, use_size=True)

    def _pos_bin(self, x, y):
        bx = np.clip((x / self.frame_w * self.pos_bins).astype(int), 0, self.pos_bins - 1)
        by = np.clip((y / self.frame_h * self.pos_bins).astype(int), 0, self.pos_bins - 1)
        return bx, by

    def _vel_bin(self, vx, vy):
        half = self.vel_bins // 2
        scale = self.frame_w / 64.0
        bx = np.clip(np.round(vx / scale).astype(int) + half, 0, self.vel_bins - 1)
        by = np.clip(np.round(vy / scale).astype(int) + half, 0, self.vel_bins - 1)
        return bx, by

    def _size_bin(self, w, h):
        bw = np.clip((w / self.frame_w * self.size_bins).astype(int), 0, self.size_bins - 1)
        bh = np.clip((h / self.frame_h * self.size_bins).astype(int), 0, self.size_bins - 1)
        return bw, bh

    def _fold_rows(self, rows) -> None:
        arr = np.array([(x, y, w, h) for (_f, _i, x, y, w, h) in rows])
        if len(arr) < 2:
            return
        bx, by = self._pos_bin(arr[:, 0], arr[:, 1])
        np.add.at(self.pos_hist, (by, bx), 1)
        if self.use_vel:
            vel = np.diff(arr[:, :2], axis=0)
            vbx, vby = self._vel_bin(vel[:, 0], vel[:, 1])
            np.add.at(self.vel_hist, (vby, vbx), 1)
        if self.use_size:
            sbw, sbh = self._size_bin(arr[:, 2], arr[:, 3])
            np.add.at(self.size_hist, (sbh, sbw), 1)
        self.total += len(arr)

    def _score_rows(self, rows) -> float:
        eps = 1e-9
        arr = np.array([(x, y, w, h) for (_f, _i, x, y, w, h) in rows])
        if len(arr) < 2:
            return 0.0
        p_pos = self.pos_hist / max(self.pos_hist.sum(), 1)
        bx, by = self._pos_bin(arr[:, 0], arr[:, 1])
        nll = -np.log(p_pos[by, bx] + eps).mean()
        if self.use_vel:
            p_vel = self.vel_hist / max(self.vel_hist.sum(), 1)
            vel = np.diff(arr[:, :2], axis=0)
            vbx, vby = self._vel_bin(vel[:, 0], vel[:, 1])
            nll -= np.log(p_vel[vby, vbx] + eps).mean()
        if self.use_size:
            p_size = self.size_hist / max(self.size_hist.sum(), 1)
            sbw, sbh = self._size_bin(arr[:, 2], arr[:, 3])
            nll -= np.log(p_size[sbh, sbw] + eps).mean()
        return float(nll)

    def _data(self):
        return dict(
            pos_hist=self.pos_hist, vel_hist=self.vel_hist,
            size_hist=self.size_hist, total=np.asarray(self.total),
        )

    def _set_data(self, d):
        self.pos_hist = d["pos_hist"]
        self.vel_hist = d["vel_hist"]
        self.size_hist = d["size_hist"]
        self.total = int(d["total"])


class StartStopAnalysis(OnlineAnalysisBase):
    """HistSS analog (``cvCreateModuleBlobTrackAnalysisHistSS``): 2-D
    histograms over each track's start and stop positions; a track whose
    (start, stop) pair is rare scores as abnormal."""

    abnormal_threshold = 12.0

    def __init__(self, frame_w: int, frame_h: int, bins: int = 16):
        super().__init__()
        self.frame_w, self.frame_h, self.bins = frame_w, frame_h, bins
        self.hist = np.zeros((bins, bins, bins, bins), np.float64)

    def _bin(self, x, y):
        bx = int(np.clip(x / self.frame_w * self.bins, 0, self.bins - 1))
        by = int(np.clip(y / self.frame_h * self.bins, 0, self.bins - 1))
        return bx, by

    def _fold_rows(self, rows) -> None:
        b = self._bin(rows[0][2], rows[0][3]) + self._bin(rows[-1][2], rows[-1][3])
        self.hist[b] += 1

    def _score_rows(self, rows) -> float:
        p = self.hist / max(self.hist.sum(), 1)
        b = self._bin(rows[0][2], rows[0][3]) + self._bin(rows[-1][2], rows[-1][3])
        return float(-np.log(p[b] + 1e-9))

    def _data(self):
        return dict(ss_hist=self.hist)

    def _set_data(self, d):
        self.hist = d["ss_hist"]


class TrackDistAnalysis(OnlineAnalysisBase):
    """TrackDist analog (``cvCreateModuleBlobTrackAnalysisTrackDist``):
    a track is normal when a previously-seen track follows a similar path —
    score = distance to the nearest stored trajectory (resampled to a fixed
    number of waypoints, mean Euclidean)."""

    abnormal_threshold = 40.0  # px mean waypoint distance

    def __init__(self, n_points: int = 16):
        super().__init__()
        self.n = n_points
        self.templates: List[np.ndarray] = []

    def _resample(self, rows) -> np.ndarray:
        arr = np.array([(x, y) for (_f, _i, x, y, _w, _h) in rows], np.float64)
        if len(arr) == 1:
            return np.repeat(arr, self.n, axis=0)
        t = np.linspace(0, len(arr) - 1, self.n)
        i0 = np.floor(t).astype(int)
        i1 = np.minimum(i0 + 1, len(arr) - 1)
        w = (t - i0)[:, None]
        return arr[i0] * (1 - w) + arr[i1] * w

    def _fold_rows(self, rows) -> None:
        if len(rows) >= 2:
            self.templates.append(self._resample(rows))

    def _score_rows(self, rows) -> float:
        q = self._resample(rows)
        if not self.templates:
            return 0.0
        dists = sorted(
            float(np.linalg.norm(q - t, axis=1).mean()) for t in self.templates
        )
        # skip the self-match (distance 0) when the track is stored
        return dists[1] if len(dists) > 1 and dists[0] < 1e-9 else dists[0]

    def _data(self):
        if self.templates:
            return dict(td_templates=np.stack(self.templates))
        return dict(td_templates=np.zeros((0, self.n, 2)))

    def _set_data(self, d):
        self.templates = [t for t in d["td_templates"]]


class IORAnalysis(OnlineAnalysisBase):
    """IOR analog (``cvCreateModuleBlobTrackAnalysisIOR``): the legacy
    "integrator of rules" runs several sub-analyzers and flags a track
    abnormal if ANY rule does — each rule thresholds INDEPENDENTLY (the
    legacy integrator ORs per-rule abnormality flags; it never renormalizes
    one rule's score by another's). Score = max over rules of
    score / rule_threshold, so ≥ 1.0 ⇔ some rule fired; scores are stable
    as new tracks arrive (no batch-max normalization)."""

    abnormal_threshold = 1.0

    def __init__(self, frame_w: int, frame_h: int, subs=None):
        super().__init__()
        self.subs = subs or [
            TrajectoryAnalysis.hist_p(frame_w, frame_h),
            StartStopAnalysis(frame_w, frame_h),
            TrackDistAnalysis(),
        ]

    def _fold_rows(self, rows) -> None:
        for s in self.subs:
            s._fold_rows(rows)

    def _score_rows(self, rows) -> float:
        return max(
            s._score_rows(rows) / s.abnormal_threshold for s in self.subs
        )

    def _data(self):
        out = {}
        for i, s in enumerate(self.subs):
            for k, v in s._data().items():
                out[f"sub{i}_{k}"] = v
        return out

    def _set_data(self, d):
        for i, s in enumerate(self.subs):
            pre = f"sub{i}_"
            s._set_data({k[len(pre):]: v for k, v in d.items() if k.startswith(pre)})


def make_analysis(name: str, frame_w: int, frame_h: int):
    """Trajectory-analysis module registry by reference nickname
    (``trackingMain.cpp:110-121``): HistPVS (default), HistP, HistPV,
    HistSS, TrackDist, IOR, or None."""
    key = (name or "none").lower()
    if key == "histpvs":
        return TrajectoryAnalysis.hist_pvs(frame_w, frame_h)
    if key == "histp":
        return TrajectoryAnalysis.hist_p(frame_w, frame_h)
    if key == "histpv":
        return TrajectoryAnalysis.hist_pv(frame_w, frame_h)
    if key == "histss":
        return StartStopAnalysis(frame_w, frame_h)
    if key == "trackdist":
        return TrackDistAnalysis()
    if key == "ior":
        return IORAnalysis(frame_w, frame_h)
    if key == "none":
        return None
    raise ValueError(f"unknown trajectory analysis {name!r}")
