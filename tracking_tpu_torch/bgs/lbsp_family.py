"""SuBSENSE (type 36) and LOBSTER (type 37), counterpart of
``tracking_tpu/bgs/lbsp_family.py``.

Self-Balanced SENsitivity SEgmenter: 50-sample colour+LBSP consensus with
per-pixel feedback (distance threshold R(x), update rate T(x), variation
modulator v(x), rolling D_min averages), blink detection, unstable-region
masking, LBSP-threshold LUT rescaling and, from 320×240 up, downsampled
camera-motion analysis with automatic partial model resets.

The step follows the reference's v1 path by default: frame t's stochastic
bank writes are logged (``pend_ctrl`` / ``pend_vals``) and replayed by frame
t+1's consensus. On CUDA tensors the consensus, the hole-fill reachability
and (in the tracker) CC labelling and assignment are hand-written kernels;
``step(..., use_kernels=False)`` runs their plain versions instead. The
CUDA consensus updates the state's banks in place.

The JAX package's two opt-in variants, under its own switches:

- ``TRACKING_TPU_CONSENSUS=v3`` (read by ``init``, see :func:`_use_v2`):
  the state carries ``bg_sum`` instead of the log, the walk only reads the
  banks (the kernel ``consensus_read``) and the step's slot writes apply
  eagerly with frame-global slots (:func:`_apply_updates_global`);
- ``TRACKING_TPU_FUSED=1`` (read by ``step``) on a v1 state: replay, walk,
  feedback and the next log in one kernel, ``consensus_feedback``.

On CPU tensors, or with ``use_kernels=False``, both take their plain
versions. The requirement is a per-pixel map: ``nRequiredBGSamples`` plus
the state's ``shrink_req_offset`` where subsenseShrink sets one.

Row-sharded mode: ``SuBSENSE.step(..., ctx=SpatialCtx)`` runs one rank of
``parallel/spatial.py``'s single-stream sharding (``lbsp_family.py:806-1400``,
every ``ctx`` branch): the frame arrives as a halo slab, the consensus (v1)
or the read-only walk (v3) runs its slab mode, RNG fields are drawn at the
global shape and row-sliced, the nonzero-descriptor count is summed over
ranks, the post-processing is ``sharded_postproc``, the motion analysis
gathers the downsampled column sums, and v3's slot writes and the refresh
read border-extended slabs. ``TRACKING_TPU_FUSED=1`` runs v1 there, as the
JAX package does (its fused step takes no ``ctx``).

LOBSTER (below SuBSENSE) is the same model with fixed thresholds: N = 35
samples, a 1/16 stochastic self and 3×3-neighbour update logged the same
way, and a 9×9 median. Its consensus is the CUDA kernel
``consensus_lobster`` on CUDA tensors; its ``step(..., ctx=)`` runs the
kernel's slab mode and the median on a slab extended by its radius
(``lbsp_family.py:484-654``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops import rng
from tracking_tpu_torch.ops.consensus import _NB3  # noqa: F401  (shrinkBGS's spread offsets)
from tracking_tpu_torch.ops.consensus import (
    apply_pending_ref,
    consensus,
    consensus_lobster,
    consensus_feedback,
    consensus_feedback_ref,
    consensus_lobster_ref,
    consensus_read,
    consensus_read_ref,
    consensus_ref,
    intra_descriptors,
    nb3_to_nb5_idx,
    pack_pending_ctrl,
    pack_pending_vals,
    recip,
    resolve_spread,
    roi_map,
    thr_closed_form,
    thr_lobster,
)
from tracking_tpu_torch.ops.feedback import FeedbackConsts, feedback
from tracking_tpu_torch.ops.filters import binary_median_blur
from tracking_tpu_torch.ops.lbsp import BORDER
from tracking_tpu_torch.ops.morphology import dilate, erode, fill_holes, morph_close

# constants from BackgroundSubtractorSuBSENSE.cpp:16-46
GHOSTDET_D_MAX = 0.010
GHOSTDET_S_MIN = 0.995
FEEDBACK_R_VAR = 0.01
FEEDBACK_V_INCR = 1.0
FEEDBACK_V_DECR = 0.1
FEEDBACK_T_DECR = 0.25
FEEDBACK_T_INCR = 0.5
FEEDBACK_T_LOWER = 2.0
FEEDBACK_T_UPPER = 256.0
UNSTABLE_REG_RATIO_MIN = 0.1
UNSTABLE_REG_RDIST_MIN = 3.0
LBSPDESC_RATIO_MIN = 0.1
LBSPDESC_RATIO_MAX = 0.5
DOWNSAMPLE_RATIO = 8
DEFAULT_FRAME_AREA = 320 * 240
DEFAULT_MEDIAN_KSIZE = 9
_RMAX = 1 << 30

# 7×7 gaussian init-sampling pattern (RandUtils.h:13-25), flattened x outer,
# y inner, for inverse-CDF sampling
_INIT_PATTERN = np.array(
    [
        [2, 4, 6, 7, 6, 4, 2],
        [4, 8, 12, 14, 12, 8, 4],
        [6, 12, 21, 25, 21, 12, 6],
        [7, 14, 25, 28, 25, 14, 7],
        [6, 12, 21, 25, 21, 12, 6],
        [4, 8, 12, 14, 12, 8, 4],
        [2, 4, 6, 7, 6, 4, 2],
    ],
    dtype=np.int32,
)
_INIT_TOT = 512
_INIT_CDF = np.cumsum(_INIT_PATTERN.T.reshape(-1))
_INIT_DX = np.repeat(np.arange(7) - 3, 7)
_INIT_DY = np.tile(np.arange(7) - 3, 7)


def _sample_offset_field(key: torch.Tensor, shape) -> torch.Tensor:
    """Gaussian-weighted 7×7 offset index per element (0..48): an
    inverse-CDF draw, ``#(cdf < r)``."""
    r = rng.randint(key, shape, 1, _INIT_TOT + 1)
    cdf = torch.as_tensor(_INIT_CDF, dtype=torch.int32, device=key.device)
    return torch.bucketize(r, cdf).clamp(0, 48)


def _refresh_samples(key, n_samples, n_refresh, start, last_color, last_desc, ok_mask, colors, descs, ctx=None):
    """refreshModel (SuBSENSE :249-291): slots [start, start+n_refresh) mod N
    take the value of a random gaussian-weighted nearby position (clamped to
    the ROI interior) where that position's ``ok_mask`` and the pixel's own
    hold. ``start`` may be an int or a 0-d tensor.

    With ``ctx`` (a rank of the row sharding, ``lbsp_family.py:134-163``)
    the inputs are the rank's rows: the offset field is drawn at the global
    shape and row-sliced, and the sources are read from border-extended
    slabs, whose rows carry the ROI clamp (the JAX package's ``shift`` hook
    reads them the same way)."""
    h, w = ok_mask.shape
    dev = ok_mask.device
    N = n_samples
    idx = _sample_offset_field(key, (n_refresh, h if ctx is None else ctx.H, w))
    if ctx is not None:
        idx = ctx.rng_rows(idx)
    dy = torch.as_tensor(_INIT_DY, device=dev)[idx]
    dx = torch.as_tensor(_INIT_DX, device=dev)[idx]
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    ok_own = ok_mask
    if ctx is None:
        rows = (ys + dy).clamp(BORDER, h - BORDER - 1)
    else:
        rows = ctx.halo + ys + dy
        last_color = tuple(ctx.extend_border(p) for p in last_color)
        last_desc = tuple(ctx.extend_border(d) for d in last_desc)
        ok_mask = ctx.extend_border(ok_mask)
    src = rows * w + (xs + dx).clamp(BORDER, w - BORDER - 1)
    ok = ok_mask.reshape(-1)[src] & ok_own[None]
    slots = (torch.arange(n_refresh, device=dev) + start) % N

    def apply(bank, plane):
        out = bank.clone()
        out[slots] = torch.where(ok, plane.reshape(-1)[src], bank[slots])
        return out

    new_colors = tuple(apply(colors[c], last_color[c]) for c in range(len(colors)))
    # int16 views: torch has no indexed write for uint16; the bits are the same
    new_descs = tuple(
        apply(descs[c].view(torch.int16), last_desc[c].to(torch.uint16).view(torch.int16)).view(torch.uint16)
        for c in range(len(descs))
    )
    return new_colors, new_descs


def _pick_neighbor(o_idx: torch.Tensor, offsets, arrays):
    """For each pixel p with drawn offset index ``o_idx[p]``, each array's
    value at p − offsets[o_idx[p]] clamped into the ROI interior
    (``lbsp_family.py:237-252``, a select over the K shifted copies there;
    one gather per array here). ``offsets`` are (x, y) pairs."""
    h, w = o_idx.shape
    dev = o_idx.device
    off = torch.as_tensor(offsets, dtype=torch.int64, device=dev)[o_idx.long()]
    rows = (torch.arange(h, device=dev)[:, None] - off[..., 1]).clamp(BORDER, h - BORDER - 1)
    cols = (torch.arange(w, device=dev)[None, :] - off[..., 0]).clamp(BORDER, w - BORDER - 1)
    src = rows * w + cols
    return tuple(a.reshape(-1)[src] for a in arrays)


def _use_v2() -> bool:
    """Consensus variant from ``TRACKING_TPU_CONSENSUS`` (``lbsp_family.py:
    255-288``): ``v1`` (the default) logs the step's bank writes for the
    next consensus; any other value but ``v2`` selects v3, whose state
    carries the bank colour sum ``bg_sum`` and applies the writes eagerly
    (:func:`_apply_updates_global`). ``v2``, the retired grouped-DMA walk,
    raises as in the JAX package."""
    mode = os.environ.get("TRACKING_TPU_CONSENSUS", "v1")
    if mode == "v2":
        raise RuntimeError(
            "TRACKING_TPU_CONSENSUS=v2 (grouped-DMA walk) was retired to "
            "attic/pallas_consensus2.py - a measured regression (PERF.md "
            "'Consensus v2 A/B'); use v3 for the eager-update research "
            "path, or see attic/README.md to reproduce the v2 A/B"
        )
    return mode != "v1"


def _use_fused() -> bool:
    """The fused whole step, ``TRACKING_TPU_FUSED=1`` (``lbsp_family.py:
    869-874``). The JAX package's ``TRACKING_TPU_FUSED_INTERP`` selects its
    interpret-mode kernel on the CPU; the port has no interpret mode (CPU
    tensors take the plain version), so it reads only this switch."""
    return os.environ.get("TRACKING_TPU_FUSED") == "1"


def _apply_updates_global(upd1, u3, u5, s1, s3, s5, vals, colors, descs, bg_sum, ctx=None):
    """Consensus v3's bank update (``lbsp_family.py:316-357``): v1's per-pixel
    write decisions with frame-global slots ``s1`` / ``s3`` / ``s5`` (0-d
    int tensors, used on the device: no host sync), applied at once to the
    ≤ 3 touched slot planes. Later writes win: self, then the 5×5-only
    spread, then the 3×3 spread. ``bg_sum`` (C-tuple int32) moves by
    new − old at each written slot. With ``ctx`` the spread sources are
    shifts of border-extended slabs of ``vals`` (``lbsp_family.py:1225-1229``).

    The banks are updated IN PLACE (the desc banks through an int16 view)
    and returned; returns (colors, descs, bg_sum)."""
    C = len(colors)
    shift_src = None
    if ctx is not None:
        vals_ext = tuple(ctx.extend_border(v) for v in vals)
        shift_src = lambda ci, dy, dx: ctx.shift_ext(vals_ext[ci], dy, dx)  # noqa: E731
    ok3, ok5, nbv = resolve_spread(vals, u3, u5, shift_src)
    bg_sum = list(bg_sum)
    writes = ((s1, upd1 != 0, vals), (s5, ok5 & ~ok3, nbv), (s3, ok3, nbv))
    for slot, mask, src in writes:
        idx = slot.reshape(1).to(torch.int64)
        for c in range(C):
            col = (src[c] & 0xFF).to(torch.uint8)
            desc = ((src[c] >> 8) & 0xFFFF).to(torch.uint16).view(torch.int16)
            old_c = colors[c].index_select(0, idx)[0]
            new_c = torch.where(mask, col, old_c)
            colors[c].index_copy_(0, idx, new_c[None])
            d16 = descs[c].view(torch.int16)
            d16.index_copy_(0, idx, torch.where(mask, desc, d16.index_select(0, idx)[0])[None])
            bg_sum[c] = bg_sum[c] + (new_c.to(torch.int32) - old_c.to(torch.int32))
    return colors, descs, tuple(bg_sum)


def _to_planes(frame: torch.Tensor) -> Tuple[Tuple[torch.Tensor, ...], bool]:
    """[H, W] or [H, W, C] u8 -> C-tuple of contiguous [H, W], was_gray."""
    if frame.ndim == 2:
        return (frame.contiguous(),), True
    return tuple(frame[..., c].contiguous() for c in range(frame.shape[-1])), False


def _from_planes(planes, was_gray: bool) -> torch.Tensor:
    return planes[0] if was_gray else torch.stack(planes, dim=-1)


@dataclasses.dataclass(frozen=True)
class SuBSENSEConfig(BGSConfig):
    fRelLBSPThreshold: float = 0.333
    nDescDistThresholdOffset: int = 3
    nMinColorDistThreshold: int = 30
    nBGSamples: int = 50
    nRequiredBGSamples: int = 2
    nSamplesForMovingAvgs: int = 100
    showOutput: bool = True


@register("SuBSENSEBGS", type_id=36, aliases=("subsense",))
class SuBSENSE(BGSAlgorithm):
    """Self-Balanced SENsitivity SEgmenter (St-Charles et al., CVPRW 2014)."""

    Config = SuBSENSEConfig

    def _kernel_kw(self, c: int):
        cfg = self.config
        return dict(
            rel=cfg.fRelLBSPThreshold,
            div=3.0 if c == 1 else 1.0,
            hi_const=float(np.rint(255 * cfg.fRelLBSPThreshold)),
            min_cd=int(cfg.nMinColorDistThreshold),
            desc_off=int(cfg.nDescDistThresholdOffset),
        )

    @staticmethod
    def _size_policy(h: int, w: int):
        """initialize() size-dependent switches (:124-140)."""
        npix = h * w
        scaling = npix >= DEFAULT_FRAME_AREA
        if scaling:
            use3x3 = not (npix > DEFAULT_FRAME_AREA * 2)
            raw_k = min(int(np.floor(npix / DEFAULT_FRAME_AREA + 0.5)) + DEFAULT_MEDIAN_KSIZE, 14)
            ksize = raw_k if raw_k % 2 else raw_k - 1
            t_lower, t_upper = FEEDBACK_T_LOWER, FEEDBACK_T_UPPER
        else:
            use3x3 = True
            ksize = DEFAULT_MEDIAN_KSIZE
            t_lower, t_upper = FEEDBACK_T_LOWER * 2, FEEDBACK_T_UPPER * 2
        return scaling, use3x3, ksize, t_lower, t_upper

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        cfg = self.config
        c = max(c, 1)
        N = cfg.nBGSamples
        _, _, _, t_lower, t_upper = self._size_policy(h, w)
        dsh, dsw = h // DOWNSAMPLE_RATIO, w // DOWNSAMPLE_RATIO
        kw = dict(device=device)

        def f32(fill):
            return torch.full((h, w), fill, dtype=torch.float32, **kw)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, **kw)

        st = {
            "t": zeros((), torch.int32),
            "key": rng.prng_key(0, device=device),
            "colors": tuple(zeros((N, h, w), torch.uint8) for _ in range(c)),
            "descs": tuple(zeros((N, h, w), torch.uint16) for _ in range(c)),
            "R": f32(1.0),
            "T": f32(t_lower),
            "v": f32(10.0),
            "mean_last": f32(0.0),
            "dmin_lt": f32(0.0),
            "dmin_st": f32(0.0),
            "raw_lt": f32(0.0),
            "raw_st": f32(0.0),
            "final_lt": f32(0.0),
            "final_st": f32(0.0),
            "unstable": zeros((h, w), torch.bool),
            "blinks": zeros((h, w), torch.bool),
            "last_color": tuple(zeros((h, w), torch.uint8) for _ in range(c)),
            "last_desc": tuple(zeros((h, w), torch.uint16) for _ in range(c)),
            "last_raw": zeros((h, w), torch.uint8),
            "last_final": zeros((h, w), torch.uint8),
            "last_blink_mask": zeros((h, w), torch.bool),
            "last_dil_inv": zeros((h, w), torch.bool),
            "lut_delta": zeros((), torch.int32),
            "ds_lt": tuple(zeros((dsh, dsw), torch.float32) for _ in range(c)),
            "ds_st": tuple(zeros((dsh, dsw), torch.float32) for _ in range(c)),
            "last_nonzero_ratio": zeros((), torch.float32),
            "frames_since_reset": zeros((), torch.int32),
            "cooldown": zeros((), torch.int32),
            "auto_reset": torch.ones((), dtype=torch.bool, **kw),
            "lr_lower": torch.full((), t_lower, dtype=torch.float32, **kw),
            "lr_upper": torch.full((), t_upper, dtype=torch.float32, **kw),
        }
        if _use_v2():
            # v3 carries the banks' colour sum instead of a write log
            st["bg_sum"] = tuple(zeros((h, w), torch.int32) for _ in range(c))
        else:
            # deferred stochastic-update log (zero ctrl = no writes)
            st["pend_ctrl"] = zeros((h, w), torch.int32)
            st["pend_vals"] = tuple(zeros((h, w), torch.int32) for _ in range(c))
        return st

    def _thr(self, c: int, delta):
        kw = self._kernel_kw(c)
        return lambda v: thr_closed_form(v, delta, kw["rel"], kw["div"], kw["hi_const"])

    def warm_start(self, state: State, frame: torch.Tensor) -> State:
        """initialize() + refreshModel(1.0) (:206-247)."""
        cfg = self.config
        planes, _ = _to_planes(frame)
        h, w = planes[0].shape
        intra, _ = intra_descriptors(planes, self._thr(len(planes), state["lut_delta"]))
        key, sub = rng.split(state["key"], 2)
        colors, descs = _refresh_samples(
            sub, cfg.nBGSamples, cfg.nBGSamples, 0, planes, intra,
            torch.ones((h, w), dtype=torch.bool, device=frame.device), state["colors"], state["descs"],
        )
        out = dict(state, key=key, colors=colors, descs=descs)
        if "bg_sum" in state:
            out["bg_sum"] = tuple(cc.to(torch.int32).sum(dim=0, dtype=torch.int32) for cc in colors)
        return out

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True, ctx=None) -> StepResult:
        """One frame. On CUDA tensors the kernels run (and the banks update in
        place) unless ``use_kernels=False``. ``ctx`` (a
        ``parallel.spatial.SpatialCtx``) runs one rank of the row-sharded
        step: ``frame`` is this rank's halo-extended slab and the state its
        rows (module docstring)."""
        cfg = self.config
        N = cfg.nBGSamples
        planes_in, was_gray = _to_planes(frame)
        if ctx is not None:
            planes_ext = planes_in  # the runner extended the frame's rows
            planes = tuple(ctx.crop(p) for p in planes_ext)
        else:
            planes = planes_in
        c = len(planes)
        h, w = planes[0].shape
        H = ctx.H if ctx is not None else h  # the global height
        dev = frame.device
        f32, i32 = torch.float32, torch.int32

        def cf(x):
            return torch.full((), x, dtype=f32, device=dev)

        scaling, use3x3_global, median_ksize, t_lower_static, t_upper_static = self._size_policy(H, w)
        roi = roi_map(h, w, dev) if ctx is None else ctx.roi(w)
        n_roi_px = (H - 2 * BORDER) * (w - 2 * BORDER)
        t = state["t"]
        keys = rng.split(state["key"], 12)
        new_key = keys[0]

        # rolling factors (:303-304); m_nFrameIndex pre-incremented
        fidx = (t + 1).to(f32)
        a_lt = cf(1.0) / torch.minimum(fidx, cf(float(cfg.nSamplesForMovingAvgs)))
        a_st = cf(1.0) / torch.minimum(fidx, cf(float(cfg.nSamplesForMovingAvgs // 4)))

        # the per-pixel requirement (:816-821); subsenseShrink raises it by 5
        # where its shrink-box mask fires. Border pixels get 0 in the walk
        # so it stops at once (:954-961); the feedback takes the true map.
        required = torch.full((h, w), cfg.nRequiredBGSamples, dtype=i32, device=dev)
        if "shrink_req_offset" in state:
            required = required + state["shrink_req_offset"]
        v2 = "bg_sum" in state  # consensus v3 (see _use_v2)
        # the fused step takes no ctx: a rank runs v1 (lbsp_family.py:870-874)
        use_fused = not v2 and ctx is None and _use_fused()
        bits = rng.as_i32(rng.field_bits(keys[2], (4, H, w)))
        if ctx is not None:
            bits = ctx.rng_rows(bits)  # the global draw, row-sliced
        consts = FeedbackConsts(
            t_incr=FEEDBACK_T_INCR, t_decr=FEEDBACK_T_DECR, t_lower=FEEDBACK_T_LOWER,
            v_incr=FEEDBACK_V_INCR, v_decr=FEEDBACK_V_DECR, r_var=FEEDBACK_R_VAR,
            rdist_min=UNSTABLE_REG_RDIST_MIN, ratio_min=UNSTABLE_REG_RATIO_MIN,
            ghost_s_min=GHOSTDET_S_MIN, ghost_d_max=GHOSTDET_D_MAX,
        )

        if use_fused:
            # -- replay + consensus + feedback + next log in one call (:1121-1170)
            fused = consensus_feedback if use_kernels else consensus_feedback_ref
            flags, pend_ctrl, pend_vals, f32o, bg_sums, colors, descs = fused(
                planes, state["colors"], state["descs"], state["pend_ctrl"], state["pend_vals"],
                state["lut_delta"], state["R"], state["unstable"], required,
                state["last_color"], state["last_desc"], bits,
                (state["last_final"], state["blinks"], state["last_blink_mask"], state["last_raw"],
                 state["last_dil_inv"]),
                (state["mean_last"], state["dmin_lt"], state["dmin_st"], state["raw_lt"], state["raw_st"],
                 state["final_lt"], state["final_st"], state["T"], state["v"]),
                (a_lt, a_st, state["lr_lower"], state["lr_upper"], state["cooldown"], t),
                **self._kernel_kw(c), use3x3_global=bool(use3x3_global), k=consts,
            )
            intra = tuple((pv >> 8) & 0xFFFF for pv in pend_vals)
            flag = lambda b: ((flags >> b) & 1) != 0  # noqa: E731
            is_fg, unstable, nz, curr_blink, blinks_pre = (flag(b) for b in range(5))
            mean_last, dmin_lt, dmin_st, raw_lt, raw_st, T, v, R = f32o
        else:
            required_eff = torch.where(roi, required, 0)
            # the slab mode: the planes as halo slabs (E = the frame's halo)
            k_planes, row_ext = (planes, 0) if ctx is None else (planes_ext, ctx.halo)
            if v2:
                # -- v3: the banks are current; the walk only reads them ------
                walk = consensus_read if use_kernels else consensus_read_ref
                count, min_desc, min_sum, intra = walk(
                    k_planes, state["colors"], state["descs"], state["lut_delta"], state["R"], state["unstable"],
                    required_eff, **self._kernel_kw(c), row_ext=row_ext,
                )
                bg_sums, colors, descs = state["bg_sum"], state["colors"], state["descs"]
            else:
                # -- pending replay + sample consensus (:332-357); with ctx the
                # pending values as border slabs too (:991-1018)
                cons = consensus if use_kernels else consensus_ref
                k_vals = state["pend_vals"] if ctx is None else tuple(ctx.extend_border(v) for v in state["pend_vals"])
                count, min_desc, min_sum, intra, bg_sums, colors, descs = cons(
                    k_planes, state["colors"], state["descs"], state["pend_ctrl"], k_vals,
                    state["lut_delta"], state["R"], state["unstable"], required_eff, **self._kernel_kw(c),
                    row_ext=row_ext,
                )
            first = t == 0
            last_color = tuple(torch.where(first, planes[ci], state["last_color"][ci]) for ci in range(c))
            last_desc = tuple(torch.where(first, intra[ci], state["last_desc"][ci].to(i32)) for ci in range(c))

            # -- feedback stage (:358-431) ------------------------------------
            fb = feedback(
                dict(
                    count=count, mind=min_desc, mins=min_sum, required=required,
                    roi=roi, planes=planes, intras=intra,
                    last_colors=last_color, last_descs=last_desc,
                    bits=tuple(bits[i] for i in range(4)),
                    mean_last=state["mean_last"], dmin_lt=state["dmin_lt"], dmin_st=state["dmin_st"],
                    raw_lt=state["raw_lt"], raw_st=state["raw_st"],
                    final_lt=state["final_lt"], final_st=state["final_st"],
                    R=state["R"], T=state["T"], v=state["v"],
                    last_final=state["last_final"], blinks_old=state["blinks"],
                    last_blink_mask=state["last_blink_mask"], last_raw=state["last_raw"],
                    last_dil_inv=state["last_dil_inv"],
                ),
                (a_lt, a_st, state["lr_lower"], state["lr_upper"], state["cooldown"]),
                C=c, N=N, use3x3_global=bool(use3x3_global), k=consts,
            )
            is_fg, unstable, nz, curr_blink, blinks_pre = fb.is_fg, fb.unstable, fb.nz, fb.curr_blink, fb.blinks_pre
            mean_last, dmin_lt, dmin_st, raw_lt, raw_st = fb.mean_last, fb.dmin_lt, fb.dmin_st, fb.raw_lt, fb.raw_st
            T, v, R = fb.T, fb.v, fb.R

            # BG self + neighbour-spread writes (:381-404)
            fires = fb.fire3.to(torch.uint8) | (fb.fire5.to(torch.uint8) << 1)
            if v2:
                # v3: applied now, at frame-global slots (:1221-1234)
                slots = rng.randint(keys[4], (3,), 0, N)
                colors, descs, bg_sums = _apply_updates_global(
                    fb.upd1, nb3_to_nb5_idx(fb.o3), fb.o5, slots[0], slots[1], slots[2],
                    pack_pending_vals(planes, intra, fires), colors, descs, bg_sums, ctx=ctx,
                )
            else:
                # v1: logged for the next step's consensus
                pend_ctrl = pack_pending_ctrl(fb.upd1, fb.slot1, nb3_to_nb5_idx(fb.o3), fb.o5, fb.slot3, fb.slot5)
                pend_vals = pack_pending_vals(planes, intra, fires)
        raw_fg = torch.where(is_fg, 255, 0).to(torch.uint8)

        # nonzero-descriptor ratio (:430-431)
        nz_sum = (nz & roi).sum().to(f32)
        if ctx is not None:
            nz_sum = ctx.psum(nz_sum)
        nz_ratio = nz_sum * recip(n_roi_px)

        # -- post-processing (:624-642) ---------------------------------------
        if ctx is None:
            pre_flood = morph_close(raw_fg, 3)
            filled = fill_holes(pre_flood, seed="corner", use_kernels=use_kernels)
            holes = (filled > 0) & ~(pre_flood > 0)
            pre_flood_eroded = erode(erode(erode(pre_flood, 3), 3), 3)
            fg1 = torch.where(is_fg | holes | (pre_flood_eroded > 0), 255, 0).to(torch.uint8)
            final = binary_median_blur(fg1, median_ksize)
            dil_inv = ~(dilate(dilate(dilate(final, 3), 3), 3) > 0)
        else:
            from tracking_tpu_torch.parallel.spatial import sharded_postproc

            final, dil_inv = sharded_postproc(ctx, raw_fg, is_fg, median_ksize, use_kernels=use_kernels)
        blinks = blinks_pre & dil_inv
        final_fg = final > 0
        final_lt = state["final_lt"] * (1 - a_lt) + final_fg.to(f32) * a_lt
        final_st = state["final_st"] * (1 - a_st) + final_fg.to(f32) * a_st

        # -- LBSP LUT rescaling (:643-654), carried as a scalar walk ----------
        last_ratio = state["last_nonzero_ratio"]
        dec_cond = (nz_ratio < LBSPDESC_RATIO_MIN) & (last_ratio < LBSPDESC_RATIO_MIN)
        inc_cond = (nz_ratio > LBSPDESC_RATIO_MAX) & (last_ratio > LBSPDESC_RATIO_MAX)
        lut_delta = torch.clamp(state["lut_delta"] - dec_cond.to(i32) + inc_cond.to(i32), -256, 256)

        # -- frame-level motion analysis + auto reset (:655-699) --------------
        lr_lower, lr_upper = state["lr_lower"], state["lr_upper"]
        cooldown = state["cooldown"]
        frames_since = state["frames_since_reset"]
        auto_reset = state["auto_reset"]
        ds_lt, ds_st = state["ds_lt"], state["ds_st"]
        if scaling:
            dsh, dsw = H // DOWNSAMPLE_RATIO, w // DOWNSAMPLE_RATIO
            r_ = DOWNSAMPLE_RATIO

            def ds_of(p):
                cells = p[: dsh * r_, : dsw * r_].to(i32).reshape(dsh, r_, dsw, r_).sum(dim=(1, 3), dtype=i32)
                return cells.to(f32) * recip(r_ * r_)

            def ds_sharded(p):
                # each rank's per-row 8-column sums, gathered: exact integers,
                # so the two-stage sum is the one-shot cell sum (:1298-1330)
                colsum = p[:, : dsw * r_].to(i32).reshape(h, dsw, r_).sum(dim=2, dtype=i32)
                full = ctx.gather_rows(colsum)[: dsh * r_].reshape(dsh, r_, dsw).sum(dim=1, dtype=i32)
                return full.to(f32) * recip(r_ * r_)

            ds = tuple((ds_of if ctx is None else ds_sharded)(planes[ci]) for ci in range(c))
            ds_lt = tuple(ds_lt[ci] * (1 - a_lt) + ds[ci] * a_lt for ci in range(c))
            ds_st = tuple(ds_st[ci] * (1 - a_st) + ds[ci] * a_st for ci in range(c))
            perpx = [(ds_st[ci] - ds_lt[ci]).abs().to(i32) for ci in range(c)]
            if c == 1:
                diff = perpx[0] // 2
            else:
                diff = torch.maximum(torch.maximum(perpx[0], perpx[1]), perpx[2])
            color_diff_ratio = diff.sum().to(f32) * recip(dsh * dsw)

            reset_thr = cfg.nMinColorDistThreshold / 2.0
            trigger = auto_reset & (frames_since <= 1000) & (color_diff_ratio >= reset_thr) & (cooldown == 0)
            n_refresh = max(int(0.1 * N), 1)
            start = rng.randint(keys[8], (), 0, N)
            # The reference refreshes after frame t's writes: the rare trigger
            # branch applies the pending log eagerly (v1; v3's banks are
            # current), refreshes, and clears the log or recomputes v3's
            # bank sum. Branching needs the flag on the host (one sync); the
            # flag is the same on every rank of a stream, so all of them
            # exchange halos in the branch together.
            if bool(trigger):
                if v2:
                    colors, descs = _refresh_samples(
                        keys[9], N, n_refresh, start, planes, intra, ~final_fg, colors, descs, ctx=ctx
                    )
                    bg_sums = tuple(cc.to(i32).sum(dim=0, dtype=i32) for cc in colors)
                else:
                    shift_src = None
                    if ctx is not None:  # the log's sources from border slabs
                        vals_ext = tuple(ctx.extend_border(v) for v in pend_vals)
                        shift_src = lambda ci, dy, dx: ctx.shift_ext(vals_ext[ci], dy, dx)  # noqa: E731
                    ac, ad, _ = apply_pending_ref(pend_ctrl, pend_vals, colors, descs, shift_src)
                    colors, descs = _refresh_samples(
                        keys[9], N, n_refresh, start, planes, intra, ~final_fg, ac, ad, ctx=ctx
                    )
                    pend_ctrl = torch.zeros_like(pend_ctrl)
            T = torch.where(trigger, torch.ones_like(T), T)
            cooldown = torch.where(trigger, cfg.nSamplesForMovingAvgs // 4, cooldown).to(i32)
            auto_reset = torch.where(
                auto_reset & (frames_since > 1000),
                False,
                torch.where(~auto_reset & (color_diff_ratio >= reset_thr * 2), True, auto_reset),
            )
            frames_since = torch.where(trigger, 0, torch.where(auto_reset, frames_since + 1, frames_since)).to(i32)
            shift = torch.clamp((color_diff_ratio * 0.5).to(i32), 0, 30)
            cap_cond = color_diff_ratio >= reset_thr / 2
            two = torch.full((), int(FEEDBACK_T_LOWER), dtype=i32, device=dev)
            top = torch.full((), int(FEEDBACK_T_UPPER), dtype=i32, device=dev)
            lr_lower = torch.where(cap_cond, torch.clamp(two >> shift, min=1).to(f32), cf(t_lower_static))
            lr_upper = torch.where(cap_cond, torch.clamp(top >> shift, min=1).to(f32), cf(t_upper_static))
            cooldown = torch.clamp(cooldown - 1, min=0)

        bg_planes = tuple(torch.round(bg_sums[ci].to(f32) * recip(N)).to(torch.uint8) for ci in range(c))
        new_state = {
            "t": t + 1,
            "key": new_key,
            "colors": colors,
            "descs": descs,
            "R": R,
            "T": T,
            "v": v,
            "mean_last": mean_last,
            "dmin_lt": dmin_lt,
            "dmin_st": dmin_st,
            "raw_lt": raw_lt,
            "raw_st": raw_st,
            "final_lt": final_lt,
            "final_st": final_st,
            "unstable": unstable,
            "blinks": blinks,
            "last_color": planes,
            "last_desc": tuple(d.to(torch.uint16) for d in intra),
            "last_raw": raw_fg,
            "last_final": final,
            "last_blink_mask": curr_blink,
            "last_dil_inv": dil_inv,
            "lut_delta": lut_delta,
            "ds_lt": ds_lt,
            "ds_st": ds_st,
            "last_nonzero_ratio": nz_ratio,
            "frames_since_reset": frames_since,
            "cooldown": cooldown,
            "auto_reset": auto_reset,
            "lr_lower": lr_lower,
            "lr_upper": lr_upper,
        }
        if v2:
            new_state["bg_sum"] = bg_sums
        else:
            new_state["pend_ctrl"] = pend_ctrl
            new_state["pend_vals"] = pend_vals
        return new_state, final, _from_planes(bg_planes, was_gray)


@dataclasses.dataclass(frozen=True)
class LOBSTERConfig(BGSConfig):
    fRelLBSPThreshold: float = 0.365
    nLBSPThresholdOffset: int = 0
    nDescDistThreshold: int = 4
    nColorDistThreshold: int = 30
    nBGSamples: int = 35
    nRequiredBGSamples: int = 2
    learningRate: float = 16.0
    showOutput: bool = True


@register("LOBSTERBGS", type_id=37, aliases=("lobster",))
class LOBSTER(BGSAlgorithm):
    """LOcal Binary Similarity segmenTER (St-Charles & Bilodeau, WACV 2014):
    consensus over N = 35 colour+LBSP samples with fixed thresholds and
    stochastic 1/16 updates."""

    Config = LOBSTERConfig

    def _kernel_kw(self, c: int):
        """The consensus's thresholds (``lbsp_family.py:509-516``)."""
        cfg = self.config
        if c == 1:
            c_sc, d_sc = cfg.nColorDistThreshold // 2, cfg.nDescDistThreshold
        else:
            c_sc, d_sc = (cfg.nColorDistThreshold * 3) // 2, (cfg.nDescDistThreshold * 3) // 2
        return dict(
            rel=cfg.fRelLBSPThreshold, offset=float(cfg.nLBSPThresholdOffset), div=2.0 if c == 1 else 1.0,
            c_sc=c_sc, d_sc=d_sc, c_tot=cfg.nColorDistThreshold * 3, d_tot=cfg.nDescDistThreshold * 3,
            req=cfg.nRequiredBGSamples,
        )

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        N = self.config.nBGSamples
        c = max(c, 1)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        return {
            "t": zeros((), torch.int32),
            "key": rng.prng_key(0, device=device),
            "colors": tuple(zeros((N, h, w), torch.uint8) for _ in range(c)),
            "descs": tuple(zeros((N, h, w), torch.uint16) for _ in range(c)),
            "last_final": zeros((h, w), torch.uint8),
            "pend_ctrl": zeros((h, w), torch.int32),
            "pend_vals": tuple(zeros((h, w), torch.int32) for _ in range(c)),
        }

    def warm_start(self, state: State, frame: torch.Tensor) -> State:
        """initialize + refreshModel(1.0) (LOBSTER.cpp:28-36)."""
        cfg = self.config
        planes, _ = _to_planes(frame)
        h, w = planes[0].shape
        kw = self._kernel_kw(len(planes))
        intra, _ = intra_descriptors(planes, lambda v: thr_lobster(v, kw["rel"], kw["offset"], kw["div"]))
        key, sub = rng.split(state["key"], 2)
        colors, descs = _refresh_samples(
            sub, cfg.nBGSamples, cfg.nBGSamples, 0, planes, intra,
            torch.ones((h, w), dtype=torch.bool, device=frame.device), state["colors"], state["descs"],
        )
        return dict(state, key=key, colors=colors, descs=descs)

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True, ctx=None) -> StepResult:
        """One frame (``lbsp_family.py:484-654``). On CUDA tensors the
        consensus kernel runs (and the banks update in place) unless
        ``use_kernels=False``. ``ctx`` runs one rank of the row-sharded step,
        as SuBSENSE's: the frame and the pending values go to the kernel's
        slab mode, the RNG fields are drawn at the global shape and
        row-sliced, and the median reads a slab extended by its radius."""
        cfg = self.config
        N = cfg.nBGSamples
        planes_in, was_gray = _to_planes(frame)
        planes = planes_in if ctx is None else tuple(ctx.crop(p) for p in planes_in)
        c = len(planes)
        h, w = planes[0].shape
        H = h if ctx is None else ctx.H
        roi = roi_map(h, w, frame.device) if ctx is None else ctx.roi(w)
        keys = rng.split(state["key"], 8)

        cons = consensus_lobster if use_kernels else consensus_lobster_ref
        if ctx is None:
            k_planes, k_vals, row_ext = planes, state["pend_vals"], 0
        else:  # the runner extended the frame's rows (:565-600)
            k_planes, row_ext = planes_in, ctx.halo
            k_vals = tuple(ctx.extend_border(v) for v in state["pend_vals"])
        count, intra, bg_sums, colors, descs = cons(
            k_planes, state["colors"], state["descs"], state["pend_ctrl"], k_vals, **self._kernel_kw(c),
            row_ext=row_ext,
        )
        is_bg = (count >= cfg.nRequiredBGSamples) & roi
        raw_fg = torch.where(roi & ~is_bg, 255, 0).to(torch.uint8)

        # stochastic self + 3×3-neighbour updates (:209-222), logged for the
        # next step; the 5×5 fields stay zero with their fire bit clear.
        # Sharded, each field is the global draw's rows (:609-611)
        def draw(key, lo, hi):
            x = rng.field_randint(key, (H, w), lo, hi)
            return x if ctx is None else ctx.rng_rows(x)

        lr = int(np.ceil(cfg.learningRate))
        self_upd = is_bg & (draw(keys[2], 0, _RMAX) % lr == 0)
        slot_self = draw(keys[3], 0, N)
        src_fire = is_bg & (draw(keys[4], 0, _RMAX) % lr == 0)
        o_idx = draw(keys[5], 0, 8)
        slot_nb = draw(keys[6], 0, N)
        zero = torch.zeros((h, w), dtype=torch.int32, device=frame.device)
        pend_ctrl = pack_pending_ctrl(self_upd, slot_self, nb3_to_nb5_idx(o_idx), zero, slot_nb, zero)
        pend_vals = pack_pending_vals(planes, intra, src_fire)

        if ctx is None:
            final = binary_median_blur(raw_fg, DEFAULT_MEDIAN_KSIZE)
        else:  # the median on a slab extended by its radius (:632-639)
            mr = DEFAULT_MEDIAN_KSIZE // 2
            final = binary_median_blur(ctx.extend_plain(raw_fg, halo=mr), DEFAULT_MEDIAN_KSIZE)[mr : mr + h]
            final = final.contiguous()
        bg_planes = tuple(torch.round(bg_sums[ci].to(torch.float32) * recip(N)).to(torch.uint8) for ci in range(c))
        new_state = {
            "t": state["t"] + 1,
            "key": keys[0],
            "colors": colors,
            "descs": descs,
            "last_final": final,
            "pend_ctrl": pend_ctrl,
            "pend_vals": pend_vals,
        }
        return new_state, final, _from_planes(bg_planes, was_gray)
