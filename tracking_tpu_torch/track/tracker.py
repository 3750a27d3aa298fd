"""Multi-object blob tracker with fixed-capacity track tables, counterpart of
``tracking_tpu/track/tracker.py``: the CC, CCMSPF, MS, MSFG and MSPF
trackers with the BD_CC and BD_Simple detectors.

Per step: CC blob extraction of the foreground mask, Kalman predict, then
either greedy track↔blob association (CC / CCMSPF; the ``greedy_assign``
kernel on the card) with CCMSPF's mean-shift refinement of colliding
tracks, or (the MS family) each track's mean-shift over its colour
template's back-projection, with detections used only for births; then the
Kalman update, candidate confirmation (BD_CC's uniform-motion rule) and
births, which capture an MS track's colour template. The step is written
as tensor ops with no data-dependent host branch, line by line with the
reference. The state is a dict with the fields of the reference's
``TrackTable``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.ops import rng
from tracking_tpu_torch.ops.assoc import BIG, greedy_assign, greedy_assign_ref
from tracking_tpu_torch.ops.cc import Blobs, extract_blobs
from tracking_tpu_torch.track import kalman
from tracking_tpu_torch.ops.xla_math import sqrt
from tracking_tpu_torch.track.meanshift import (
    meanshift_color_refine, meanshift_refine_batch, meanshift_refine_batch_sharded, particle_color_refine,
    window_color_hist,
)


@dataclasses.dataclass(frozen=True)
class TrackerConfig(BGSConfig):
    maxTracks: int = 32
    maxBlobs: int = 64
    minBlobArea: int = 25
    newBlobDetectFrames: int = 5
    maxLostFrames: int = 10
    gateDistance: float = 2.0
    candidateGate: float = 1.5
    useMeanShiftCollision: bool = True
    # CC and CCMSPF associate detections (CCMSPF adds the mean-shift
    # collision resolver); the MS family tracks by mean-shift over each
    # track's colour back-projection (MS: colour only; MSFG: x FG mask;
    # MSPF: particle jitter, then mean-shift), detections feeding births only
    trackerType: str = "CCMSPF"  # CC | CCMSPF | MS | MSFG | MSPF
    minTrackMass: float = 4.0
    blobDetector: str = "BD_CC"  # BD_CC | BD_Simple
    uniformMotionTol: float = 0.7


class Tracks(NamedTuple):
    """Per-frame output (padded to maxTracks): Kalman-filtered x/y/w/h and
    the raw associated measurements rx/ry/rw/rh."""

    active: torch.Tensor
    ids: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor
    rx: torch.Tensor
    ry: torch.Tensor
    rw: torch.Tensor
    rh: torch.Tensor


def _blob_xywh(blobs: Blobs) -> torch.Tensor:
    return torch.stack(
        [blobs.cx, blobs.cy, blobs.w.to(torch.float32), blobs.h.to(torch.float32)], dim=-1
    )


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a − b| over the last axis of 2-vectors, as ``jnp.linalg.norm``
    computes it: sqrt(dx² + dy²), correctly rounded."""
    d = a - b
    return sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def _mean2(a: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] + a[..., 1]) * 0.5


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), dim=0, dtype=torch.int32)


def _count(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).sum(dtype=torch.int32)


def _scatter_max(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``jnp.full(n, -1).at[idx].max(vals)``."""
    out = torch.full((n,), -1, dtype=torch.int32, device=vals.device)
    return out.scatter_reduce_(0, idx.long(), vals.to(torch.int32), reduce="amax", include_self=True)


MS_FAMILY = ("MS", "MSFG", "MSPF")


class BlobTracker:
    """``state = init(device)``, ``state, tracks = step(state, mask)``."""

    def __init__(self, config: TrackerConfig | None = None, **kw):
        cfg = config or TrackerConfig()
        if kw:
            cfg = cfg.replace(**kw)
        if cfg.trackerType.upper() not in ("CC", "CCMSPF") + MS_FAMILY:
            raise ValueError(f"unknown trackerType {cfg.trackerType!r}")
        if cfg.blobDetector.upper() not in ("BD_CC", "BD_SIMPLE"):
            raise ValueError(f"unknown blobDetector {cfg.blobDetector!r}")
        self.config = cfg

    def empty_tracks(self, device="cuda") -> Tracks:
        """All-inactive output with the step's shapes and dtypes (what the
        app records while the FG detector trains alone, ``FGTrainFrames``)."""
        K = self.config.maxTracks
        z = torch.zeros(K, dtype=torch.float32, device=device)
        return Tracks(active=torch.zeros(K, dtype=torch.bool, device=device),
                      ids=torch.full((K,), -1, dtype=torch.int32, device=device),
                      x=z, y=z, w=z, h=z, rx=z, ry=z, rw=z, rh=z)

    def init(self, device="cuda") -> dict:
        K = self.config.maxTracks
        kp = kalman.default_params(device=device)
        kx, kP = kalman.kalman_init(K, kp)
        kw = dict(device=device)
        return {
            "active": torch.zeros(K, dtype=torch.bool, **kw),
            "ids": torch.full((K,), -1, dtype=torch.int32, **kw),
            "kx": kx,
            "kP": kP,
            "age": torch.zeros(K, dtype=torch.int32, **kw),
            "lost": torch.zeros(K, dtype=torch.int32, **kw),
            "cand_pos": torch.zeros((K, 4), dtype=torch.float32, **kw),
            "cand_age": torch.zeros(K, dtype=torch.int32, **kw),
            "next_id": torch.zeros((), dtype=torch.int32, **kw),
            "hist": torch.zeros((K, 512), dtype=torch.float32, **kw),
            "key": rng.prng_key(7, device=device),
            "cand_vel": torch.zeros((K, 2), dtype=torch.float32, **kw),
        }

    def cost_matrix(self, pred_pos, active, blob_pos, blob_ok):
        """Gated [K, B] association cost: centre distance over the mean
        track/blob size; 1e9 where a pair is invalid or beyond the gate."""
        cfg = self.config
        d = _dist(pred_pos[:, None, :2], blob_pos[None, :, :2])
        one = torch.ones((), dtype=torch.float32, device=pred_pos.device)
        scale = 0.5 * (
            torch.maximum(_mean2(pred_pos[:, None, 2:4]), one) + torch.maximum(_mean2(blob_pos[None, :, 2:4]), one)
        )
        cost = d / scale
        big = torch.full((), BIG, dtype=torch.float32, device=pred_pos.device)
        cost = torch.where(active[:, None] & blob_ok[None, :], cost, big)
        return torch.where(cost <= cfg.gateDistance, cost, big).contiguous()

    def step(
        self, state: dict, fg_mask: torch.Tensor, frame: torch.Tensor | None = None, use_kernels: bool = True,
        blobs: Blobs | None = None, ctx=None,
    ) -> Tuple[dict, Tracks]:
        """One step on a foreground mask [H, W] (u8 or bool). On CUDA tensors
        the CC, assignment and Kalman kernels run unless ``use_kernels=False``.

        ``frame``: the [H, W, 3] (or grey [H, W]) u8 frame, which the MS
        family tracks on; without it their templates are all ones and the
        weight is the FG mask.

        ``blobs``: a precomputed blob table (the row-sharded pipeline's
        ``sharded_extract_blobs``). ``ctx``: a ``parallel.spatial.SpatialCtx``
        when ``fg_mask`` is this rank's rows; the CCMSPF refinement then sums
        its window moments over the ranks (``tracker.py:221-300``)."""
        cfg = self.config
        K = cfg.maxTracks
        dev = fg_mask.device
        kp = kalman.default_params(device=dev)
        if blobs is None:
            blobs = extract_blobs(fg_mask, max_blobs=cfg.maxBlobs, use_kernels=use_kernels)
        blob_ok = blobs.area >= cfg.minBlobArea
        blob_pos = _blob_xywh(blobs)
        four = torch.full((), 4.0, dtype=torch.float32, device=dev)

        ttype = cfg.trackerType.upper()
        ms_family = ttype in MS_FAMILY
        fg_f = None
        if ms_family or (cfg.useMeanShiftCollision and ttype == "CCMSPF"):
            fg_f = (fg_mask > 0).to(torch.float32)
        if frame is not None and frame.ndim == 2:
            frame = frame[..., None].expand(-1, -1, 3)

        # 1) Kalman predict
        kx, kP = (kalman.kalman_predict if use_kernels else kalman.kalman_predict_ref)(state["kx"], state["kP"], kp)
        pred_pos = kx[:, :4]
        new_key = state["key"]

        if not ms_family:
            # 2) associate active tracks with blobs
            cost = self.cost_matrix(pred_pos, state["active"], blob_pos, blob_ok)
            assign, taken = (greedy_assign if use_kernels else greedy_assign_ref)(cost)
            matched = assign >= 0
            z = blob_pos[torch.clamp(assign, 0, cfg.maxBlobs - 1).long()]

            # CCMSPF collision resolution: tracks whose predicted boxes overlap
            # take the mean-shift centre over the FG mask as their measurement
            if cfg.useMeanShiftCollision and ttype == "CCMSPF":
                px, py = pred_pos[:, 0], pred_pos[:, 1]
                pw = torch.maximum(pred_pos[:, 2], four)
                ph = torch.maximum(pred_pos[:, 3], four)
                dx = (px[:, None] - px[None, :]).abs()
                dy = (py[:, None] - py[None, :]).abs()
                eye = torch.eye(K, dtype=torch.bool, device=dev)
                overlap = (
                    (dx < (pw[:, None] + pw[None, :]) / 2)
                    & (dy < (ph[:, None] + ph[None, :]) / 2)
                    & state["active"][:, None]
                    & state["active"][None, :]
                    & ~eye
                )
                colliding = overlap.any(dim=1) & matched
                if ctx is None:
                    ms_y, ms_x, ms_mass = meanshift_refine_batch(fg_f, py, px)
                else:
                    ms_y, ms_x, ms_mass = meanshift_refine_batch_sharded(ctx, fg_f, py, px)
                ms_ok = colliding & (ms_mass > 0)
                z = torch.stack(
                    [torch.where(ms_ok, ms_x, z[:, 0]), torch.where(ms_ok, ms_y, z[:, 1]), z[:, 2], z[:, 3]], dim=1
                )
        else:
            # 2') MS family: each track's mean-shift over its colour
            # template's back-projection (without a frame the template is all
            # ones and the weight the FG mask); detections only feed births
            frame_u8 = frame if frame is not None else torch.zeros(fg_mask.shape + (3,), dtype=torch.uint8, device=dev)
            use_fg = ttype in ("MSFG", "MSPF") or frame is None
            if ttype == "MSPF":
                new_key, sub = rng.split(state["key"])
                ms_y, ms_x, mass = particle_color_refine(
                    frame_u8, fg_f, state["hist"], rng.split(sub, K), pred_pos[:, 1], pred_pos[:, 0], use_fg
                )
            else:
                ms_y, ms_x, mass = meanshift_color_refine(
                    frame_u8, fg_f, state["hist"], pred_pos[:, 1], pred_pos[:, 0], use_fg
                )
            matched = state["active"] & (mass >= cfg.minTrackMass)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            z = torch.stack([ms_x, ms_y, torch.maximum(pred_pos[:, 2], zero), torch.maximum(pred_pos[:, 3], zero)],
                            dim=1)
            # suppress detections covering tracked objects (entries only)
            one = torch.ones((), dtype=torch.float32, device=dev)
            d = _dist(z[:, None, :2], blob_pos[None, :, :2])
            scale = 0.5 * (
                torch.maximum(_mean2(z[:, None, 2:4]), one) + torch.maximum(_mean2(blob_pos[None, :, 2:4]), one)
            )
            taken = ((d / scale <= cfg.gateDistance) & matched[:, None]).any(dim=0)

        kx, kP = (kalman.kalman_update if use_kernels else kalman.kalman_update_ref)(kx, kP, z, matched, kp)

        act_i = state["active"].to(torch.int32)
        lost = torch.where(matched, 0, state["lost"] + act_i).to(torch.int32)
        active = state["active"] & (lost <= cfg.maxLostFrames)
        age = state["age"] + act_i

        # 3) candidates: unmatched valid blobs extend a live candidate within
        #    candidateGate of its last position
        free_blob = blob_ok & ~taken
        cand_pos0, cand_age0 = state["cand_pos"], state["cand_age"]
        cand_live = cand_age0 > 0
        dcand = _dist(cand_pos0[:, None, :2], blob_pos[None, :, :2])
        cscale = torch.maximum(_mean2(cand_pos0[:, None, 2:4]), four)
        cmatch = (dcand / cscale <= cfg.candidateGate) & cand_live[:, None] & free_blob[None, :]
        has_cmatch = cmatch.any(dim=1)
        cblob = torch.argmax(cmatch.to(torch.int32), dim=1)
        new_vel = blob_pos[cblob][:, :2] - cand_pos0[:, :2]
        if cfg.blobDetector.upper() == "BD_CC":
            vel_ok = (cand_age0 < 2) | (_dist(new_vel, state["cand_vel"]) <= cfg.uniformMotionTol * cscale[:, 0])
        else:
            vel_ok = torch.ones_like(has_cmatch)
        cand_pos = torch.where(has_cmatch[:, None], blob_pos[cblob], cand_pos0)
        cand_vel = torch.where(has_cmatch[:, None], new_vel, torch.zeros_like(new_vel))
        cand_age = torch.where(has_cmatch, torch.where(vel_ok, cand_age0 + 1, 1), 0).to(torch.int32)
        consumed = torch.zeros(cfg.maxBlobs, dtype=torch.int32, device=dev).scatter_reduce_(
            0, cblob, has_cmatch.to(torch.int32), reduce="amax", include_self=True
        ) > 0
        free_blob = free_blob & ~consumed

        # 4) new candidates from the remaining blobs into empty slots
        empty_cand = cand_age == 0
        cand_slot_rank = _cumsum(empty_cand) - 1
        blob_rank = _cumsum(free_blob) - 1
        place = free_blob & (blob_rank < _count(empty_cand))
        slot_ranks = torch.where(empty_cand, cand_slot_rank, -1)
        blob_idx = torch.arange(cfg.maxBlobs, dtype=torch.int32, device=dev)
        blob_for_rank = _scatter_max(
            K, torch.clamp(torch.where(place, blob_rank, K - 1), 0, K - 1), torch.where(place, blob_idx, -1)
        )
        slot_blob = blob_for_rank[torch.clamp(slot_ranks, 0, K - 1).long()]
        new_cand = empty_cand & (slot_ranks >= 0) & (slot_blob >= 0)
        cand_pos = torch.where(
            new_cand[:, None], blob_pos[torch.clamp(slot_blob, 0, cfg.maxBlobs - 1).long()], cand_pos
        )
        cand_age = torch.where(new_cand, 1, cand_age).to(torch.int32)

        # 5) promote mature candidates to new tracks in free slots
        mature = cand_age >= cfg.newBlobDetectFrames
        free_track = ~active
        track_rank = _cumsum(free_track) - 1
        mature_rank = _cumsum(mature) - 1
        promote_c = mature & (mature_rank < _count(free_track))
        cand_idx = torch.arange(K, dtype=torch.int32, device=dev)
        cand_for_rank = _scatter_max(
            K, torch.clamp(torch.where(promote_c, mature_rank, K - 1), 0, K - 1), torch.where(promote_c, cand_idx, -1)
        )
        slot_cand = cand_for_rank[torch.clamp(track_rank, 0, K - 1).long()]
        birth = free_track & (slot_cand >= 0) & (track_rank < _count(promote_c))
        birth_pos = cand_pos[torch.clamp(slot_cand, 0, K - 1).long()]
        kx, kP = kalman.kalman_reset_slot(kx, kP, birth, birth_pos, kp)

        # MS family: capture the colour template at birth
        hist = state["hist"]
        if ms_family:
            if frame is not None:
                bh = window_color_hist(frame, fg_f, birth_pos[:, 1], birth_pos[:, 0])
            else:  # all ones: the weight is the FG mask (mass in FG pixels)
                bh = torch.ones((K, hist.shape[1]), dtype=torch.float32, device=dev)
            hist = torch.where(birth[:, None], bh, hist)
        birth_order = _cumsum(birth) - 1
        ids = torch.where(birth, state["next_id"] + birth_order, state["ids"]).to(torch.int32)
        next_id = state["next_id"] + _count(birth)
        active = active | birth
        age = torch.where(birth, 0, age).to(torch.int32)
        lost = torch.where(birth, 0, lost).to(torch.int32)
        cand_age = torch.where(promote_c, 0, cand_age).to(torch.int32)
        ids = torch.where(active, ids, -1).to(torch.int32)

        new_state = {
            "active": active,
            "ids": ids,
            "kx": kx,
            "kP": kP,
            "age": age,
            "lost": lost,
            "cand_pos": cand_pos,
            "cand_age": cand_age,
            "next_id": next_id,
            "hist": hist,
            "key": new_key,
            "cand_vel": cand_vel,
        }
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        kw_, kh_ = torch.maximum(kx[:, 2], zero), torch.maximum(kx[:, 3], zero)
        tracks = Tracks(
            active=active,
            ids=ids,
            x=kx[:, 0],
            y=kx[:, 1],
            w=kw_,
            h=kh_,
            rx=torch.where(matched, z[:, 0], kx[:, 0]),
            ry=torch.where(matched, z[:, 1], kx[:, 1]),
            rw=torch.where(matched, z[:, 2], kw_),
            rh=torch.where(matched, z[:, 3], kh_),
        )
        return new_state, tracks
