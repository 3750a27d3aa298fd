"""LbpMrf (ustc type 30, Kertész's texture-based detection), counterpart of
``tracking_tpu/bgs/lbp_mrf.py`` (``ck/LbpMrf.cpp`` over
``ck/MotionDetection.cpp``).

Per frame: the BGR input taken as RGB into CIELuv (sRGB inverse gamma
first); its u plane resized to 32×24 (``ops/resize``) detects scene cuts
(more than 80 % of the pixels changed by more than 12 resets the models);
the grey of the Luv image, the "special" LBP on a 5×5 patch, codes >> 6;
per model pixel (every other column of the (W − 4)×(H − 4) grid, the last
model column visited twice on rows with y % 2 == gridW % 2) a masked 5×5
histogram against three stored histograms, with the reference's
replace / blend / background-selection rules; the 2-label MRF on the
background rate cut exactly (``ops/mincut``, ``mrf_solver="exact"``) or
relaxed by red / black ICM (``"icm"``); then the mask assembled from the
model grid, hole-filled from the corner (``ops/morphology.fill_holes``: the
CUDA ``flood_reach`` kernel on the card) and eroded 3×3.

Every quirk of the JAX module is kept (the strict highest-index tie-break,
the 0 → NH − 1 … 1 minimum-weight visit, one bubble pass, the short-memcpy
fresh path, the last column's double visit). Float order as XLA:CPU runs
the JAX step (read from its optimized HLO): ``x / 255``, ``/ 13`` and
``/ 100`` are products by f32 reciprocals, the constant chains of the Luv
scaling fold (``· 255 / 354`` is one product by f32(255 · f32(1/354))),
``x - c`` is an addition of −c; ``** 2.4`` and ``cbrt`` are
``xla_math.powf``.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops.color import fold
from tracking_tpu_torch.ops.consensus import recip
from tracking_tpu_torch.ops.mincut import grid_mincut_sink_mask
from tracking_tpu_torch.ops.morphology import erode, fill_holes
from tracking_tpu_torch.ops.resize import resize_bilinear
from tracking_tpu_torch.ops.xla_math import powf
from tracking_tpu_torch.track.meanshift import sequential_sum

AREA = 5
BINS = 8
NH = 3  # histograms per pixel
PR_THRES = 0.75
BG_THRES = 0.95
LRATE = 0.01
MINCUT_W = 8.0
SHIFT = 6  # log2(256/8)+1
# cvCircle((2,2), r=2, filled) on 5×5: the 13-pixel mask
_MASK = np.array([[0, 0, 1, 0, 0], [0, 1, 1, 1, 0], [1, 1, 1, 1, 1], [0, 1, 1, 1, 0], [0, 0, 1, 0, 0]], bool)
SAMPLE_PX = int(_MASK.sum())

_INV255 = recip(255.0)
_LIN = fold(_INV255, recip(12.92))
_INV1055 = recip(1.055)
_L_SCALE = fold(255.0, recip(100.0))
_U_SCALE = fold(255.0, recip(354.0))
_V_SCALE = fold(255.0, recip(262.0))
_PCT = fold(recip(768.0), 100.0)  # 100 · mean over the 24×32 scene-cut grid


def _rgb2luv_u8(img: torch.Tensor) -> torch.Tensor:
    """OpenCV CV_RGB2Luv on u8 [..., 3] with channel 0 taken as R (the
    reference feeds BGR through MEImage's RGB pipeline), sRGB inverse gamma
    first (``lbp_mrf.py:78-109``)."""
    f32 = torch.float32

    def gam(u8):
        v = u8.to(f32)
        c = v * _INV255
        return torch.where(c <= 0.04045, v * _LIN, powf((c + 0.055) * _INV1055, 2.4))

    r, g, b = (gam(img[..., i]) for i in range(3))
    x = 0.412453 * r + 0.357580 * g + 0.180423 * b
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    lum = torch.where(y > 0.008856, 116.0 * powf(y, 1.0 / 3.0) + (-16.0), 903.3 * y)
    d = x + 15.0 * y + 3.0 * z
    d = torch.where(d == 0, torch.full((), 1e-6, dtype=f32, device=img.device), d)
    u_p = 4.0 * x / d
    v_p = 9.0 * y / d
    u = 13.0 * lum * (u_p + (-0.19793943))
    v = 13.0 * lum * (v_p + (-0.46831096))
    out = [torch.clamp(torch.round(lum * _L_SCALE), 0, 255), torch.clamp(torch.round((u + 134.0) * _U_SCALE), 0, 255),
           torch.clamp(torch.round((v + 140.0) * _V_SCALE), 0, 255)]
    return torch.stack(out, -1).to(torch.uint8)


def _lbp_special(gray: torch.Tensor) -> torch.Tensor:
    """MEImage lbp_Special (MEImage.cpp:783-813): integer averaged-group
    comparisons on a 5×5 patch; the 2-px border stays 0."""
    h, w = gray.shape
    p = F.pad(gray.to(torch.int32), (2, 2, 2, 2))

    def s(dy, dx):
        return p[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]

    center = (s(0, 1) + s(0, -1) + s(-1, 0) + s(1, 0)) // 4
    groups = [
        ((s(-2, -2) + s(-2, -1) + s(-1, -2) + s(-1, -1)) // 4, 1),
        ((s(-1, 0) + s(-2, 0)) // 2, 2),
        ((s(-2, 2) + s(-2, 1) + s(-1, 2) + s(-1, 1)) // 4, 4),
        ((s(0, -1) + s(0, -2)) // 2, 8),
        ((s(0, 1) + s(0, 2)) // 2, 16),
        ((s(2, -2) + s(2, -1) + s(1, -2) + s(1, -1)) // 4, 32),
        ((s(1, 0) + s(-2, 0)) // 2, 64),  # faithful: mixes the +1 and −2 rows
        ((s(2, 2) + s(2, 1) + s(1, 2) + s(1, 1)) // 4, 128),
    ]
    code = torch.zeros((h, w), dtype=torch.int32, device=gray.device)
    for val, bit in groups:
        code = code + torch.where(center <= val, bit, 0)
    out = torch.zeros_like(code)
    out[2 : h - 2, 2 : w - 2] = code[2 : h - 2, 2 : w - 2]
    return out


_GRID_KEYS = ("hist", "weights", "bg_flag", "life", "inited")
# called with each stage's name as a step finishes it (the on-card
# per-stage timing sets it); None otherwise
stage_hook = None


def _stage(name: str) -> None:
    if stage_hook is not None:
        stage_hook(name)


@lru_cache(maxsize=None)
def _assembly(h: int, w: int, device: str):
    """The mask assembly's index maps for an h×w frame (``lbp_mrf.py:429-443``):
    the directly painted cells, the model columns of each grid column and of
    its left and right neighbours, and where those neighbours exist."""
    gh, gw = h - AREA + 1, w - AREA + 1
    gwm = gw // 2
    xs, ys = np.arange(gw), np.arange(gh)
    out = ((ys[:, None] % 2) == ((xs[None, :] + 1) % 2), np.minimum(xs // 2, gwm - 1), np.maximum(xs // 2 - 1, 0),
           np.minimum(xs // 2 + 1, gwm - 1), (xs > 1)[None], (xs < w - AREA - 1)[None])
    return tuple(torch.from_numpy(a if a.dtype == bool else a.astype(np.int64)).to(device) for a in out)


@dataclasses.dataclass(frozen=True)
class LbpMrfConfig(BGSConfig):
    showOutput: bool = True
    # "exact" = the BK-parity integer min cut; "icm" = the red / black
    # relaxation
    mrf_solver: str = "exact"
    icm_sweeps: int = 8


@register("LbpMrf", type_id=30, aliases=("lbp-mrf",))
class LbpMrf(BGSAlgorithm):
    Config = LbpMrfConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        gh, gw = h - AREA + 1, w - AREA + 1
        gwm = gw // 2
        kw = dict(device=device)
        return {
            "t": torch.zeros((), dtype=torch.int32, **kw),
            "hist": torch.zeros((NH, BINS, gh, gwm), dtype=torch.float32, **kw),
            "weights": torch.full((NH, gh, gwm), float(np.float32(1.0 / NH)), dtype=torch.float32, **kw),
            "bg_flag": torch.ones((NH, gh, gwm), dtype=torch.bool, **kw),
            "life": torch.zeros((gh, gwm), dtype=torch.int32, **kw),
            "prev_blue": torch.zeros((24, 32), dtype=torch.float32, **kw),
            "inited": torch.zeros((gh, gwm), dtype=torch.bool, **kw),
        }

    @staticmethod
    def _window_hist(codes, gh, gw):
        """[8, gh, gw] masked 5×5 histograms of every window position."""
        onehot = (codes[None] == torch.arange(BINS, device=codes.device)[:, None, None]).to(torch.float32)
        acc = torch.zeros((BINS, gh, gw), dtype=torch.float32, device=codes.device)
        for dy in range(AREA):
            for dx in range(AREA):
                if _MASK[dy, dx]:
                    acc = acc + onehot[:, dy : dy + gh, dx : dx + gw]
        return acc

    @staticmethod
    def _update_models(st, hist_now, fresh, full_fresh=None):
        """UpdateHUPixelData (``MotionDetection.cpp:806-960``) over the model
        grid, with the quirks of ``lbp_mrf.py:177-300``. Returns (state,
        background rate)."""
        h, w, bgf = st["hist"], st["weights"], st["bg_flag"]
        dev = h.device
        life = st["life"] + 1
        inter = sequential_sum(torch.minimum(hist_now[None], h), 1) * recip(SAMPLE_PX)  # [NH, gh, gwm]
        bg_rate = torch.clamp(torch.where(bgf, inter, -1.0).amax(dim=0), min=0.0)
        # ties keep the highest index (strict improvement, i = NH-1 … 0)
        best = (NH - 1) - torch.argmax(inter.flip(0), dim=0)
        ks = torch.arange(NH, device=dev)[:, None, None]
        best_oh = ks == best[None]
        replace = (inter < PR_THRES).all(dim=0)

        # replace path: the min-weight histogram, visited 0 then NH-1 … 1
        min_i = torch.zeros_like(best)
        min_w = w[0]
        for i in range(NH - 1, 0, -1):
            min_i = torch.where(w[i] < min_w, i, min_i)
            min_w = torch.minimum(min_w, w[i])
        min_oh = ks == min_i[None]
        w_rep = torch.where(min_oh, 0.01, w)
        w_rep = w_rep / ((w_rep[0] + w_rep[1]) + w_rep[2])[None]
        h_rep = torch.where(min_oh[:, None], hist_now[None], h)
        bgf_rep = min_oh.logical_not() & bgf

        # update path
        lr = LRATE + torch.where(life < 100, (100 - life).to(torch.float32) * recip(100.0), 0.0)
        h_upd = torch.where(best_oh[:, None], (1.0 - lr)[None, None] * h + lr[None, None] * hist_now[None], h)
        w_upd = lr[None] * best_oh.to(torch.float32) + (1.0 - lr)[None] * w
        # background selection: one bubble pass, then the tail-cumulative rule
        pos_w = [w_upd[i] for i in range(NH)]
        pos_i = [torch.full_like(best, i) for i in range(NH)]
        for i in range(NH - 1, 0, -1):
            swap = pos_w[i] <= pos_w[i - 1]
            pos_w[i], pos_w[i - 1] = torch.where(swap, pos_w[i - 1], pos_w[i]), torch.where(swap, pos_w[i], pos_w[i - 1])
            pos_i[i], pos_i[i - 1] = torch.where(swap, pos_i[i - 1], pos_i[i]), torch.where(swap, pos_i[i], pos_i[i - 1])
        added = []
        cum = torch.zeros_like(w_upd[0])
        for k in range(NH - 1, -1, -1):  # tail first, f32 adds in the C++ order
            added.append((k, cum <= BG_THRES))
            cum = cum + pos_w[k]
        bgf_upd = []
        for i in range(NH):
            flag = torch.zeros_like(bgf[0])
            for k, a in added:
                flag = torch.where(pos_i[k] == i, a, flag)
            bgf_upd.append(flag)
        bgf_upd = torch.stack(bgf_upd)

        hist2 = torch.where(replace[None, None], h_rep, h_upd)
        w2 = torch.where(replace[None], w_rep, w_upd)
        bgf2 = torch.where(replace[None], bgf_rep, bgf_upd)

        # fresh (first init / scene cut): bins 0-1 from the current
        # histogram, bins 2+ keep their contents (the short memcpy), but for
        # the full-size last-column pre-visit (full_fresh)
        if full_fresh is not None:
            h_fresh = full_fresh[None].expand(h.shape)
        else:
            h_fresh = torch.cat([hist_now[None, :2].expand((NH, 2) + h.shape[2:]), h[:, 2:]], dim=1)
        hist2 = torch.where(fresh[None, None], h_fresh, hist2)
        w2 = torch.where(fresh[None], float(np.float32(1.0 / NH)), w2)
        bgf2 = bgf2 | fresh[None]
        life = torch.where(fresh, 0, life)
        bg_rate = torch.where(fresh, 1.0, bg_rate)
        return dict(st, hist=hist2, weights=w2, bg_flag=bgf2, life=life, inited=torch.ones_like(st["inited"])), bg_rate

    def _mrf_cut(self, bg_rate):
        """The 2-label MRF mask (``GetMotionsMaskHU`` :1279-1321): FG [gh, gwm]."""
        cfg = self.config
        gh, gw = bg_rate.shape
        dev = bg_rate.device
        has = torch.zeros((gh, gw), dtype=torch.bool, device=dev)
        has[1:, 1:] = True  # edges only for nodes with x > 0 and y > 0
        if cfg.mrf_solver == "exact":
            # (short)(8f · (1 − rate)): the f32 product truncated toward 0
            t_cap = torch.trunc(MINCUT_W * (1.0 - bg_rate)).to(torch.int32)
            return grid_mincut_sink_mask(1 - t_cap, has, has)

        u_bg = MINCUT_W * (1.0 - bg_rate)
        lab = (u_bg > 1.0).to(torch.float32)  # FG where the unary is cheaper
        hf = has.to(torch.float32)
        down_w = F.pad(hf, (0, 0, 0, 1))[1:]
        right_w = F.pad(hf, (0, 1, 0, 0))[:, 1:]
        cnt = ((hf + down_w) + hf) + right_w
        yy, xx = torch.meshgrid(torch.arange(gh, device=dev), torch.arange(gw, device=dev), indexing="ij")
        red = (yy + xx) % 2 == 0

        def half(lab, colour):
            p = F.pad(lab, (1, 1, 1, 1))
            s1 = ((p[:-2, 1:-1] * hf + p[2:, 1:-1] * down_w) + p[1:-1, :-2] * hf) + p[1:-1, 2:] * right_w
            e_fg = 1.0 + (cnt - s1)  # disagreements if FG
            e_bg = u_bg + s1
            return torch.where(colour, (e_fg < e_bg).to(torch.float32), lab)

        for _ in range(cfg.icm_sweeps):
            lab = half(lab, red)
            lab = half(lab, ~red)
        return lab > 0.5

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame. ``use_kernels=False`` takes the plain hole fill on the
        card too."""
        f3 = frame if frame.ndim == 3 else frame[..., None].expand(*frame.shape, 3)
        h, w = f3.shape[:2]
        gh, gw = h - AREA + 1, w - AREA + 1
        gwm = gw // 2
        dev = frame.device
        t = state["t"]

        luv = _rgb2luv_u8(f3)
        _stage("luv")
        blue = resize_bilinear(luv[..., 1].to(torch.float32), (24, 32), use_kernels)
        changed = ((blue - state["prev_blue"]).abs() > 12).sum(dtype=torch.int32).to(torch.float32)
        reset_all = (changed * _PCT > 80.0) & (t > 0)
        _stage("resize")

        lf = luv.to(torch.float32)
        gray = torch.clamp(torch.round((0.299 * lf[..., 0] + 0.587 * lf[..., 1]) + 0.114 * lf[..., 2]), 0, 255)
        codes = _lbp_special(gray.to(torch.uint8)) >> SHIFT
        _stage("lbp")
        hist_all = self._window_hist(codes, gh, gw)  # [8, gh, gw]
        _stage("histograms")

        # the last model column's pre-visit with the window at x = gw − 1 on
        # rows where y % 2 == gw % 2 (UpdateModelHU :628-718); fresh frozen
        # before it, so both visits take their init paths on those frames
        # (the update is per pixel: it runs on that column alone)
        rows = torch.arange(gw % 2, gh, 2, device=dev)
        fresh0 = reset_all | ~state["inited"]
        last = {k: state[k][..., gwm - 1 : gwm] for k in _GRID_KEYS}
        win = hist_all[:, :, gw - 1 : gw]
        st2, _ = self._update_models(last, win, fresh0[:, gwm - 1 : gwm], full_fresh=win)
        st = dict(state)
        for k in _GRID_KEYS:  # in place: the step consumes its state
            st[k][..., rows, gwm - 1] = st2[k][..., rows, 0]
        _stage("update_last_column")

        hist_now = hist_all[:, :, 0 : 2 * gwm : 2]  # windows at even x
        st, bg_rate = self._update_models(st, hist_now, fresh0)
        _stage("update")
        fg_model = self._mrf_cut(bg_rate)  # [gh, gwm]
        _stage("min_cut")

        # assemble the mask (GetMotionsMaskHU :1256-1366)
        direct, xm, xl, xr, left_ok, right_ok = _assembly(h, w, str(dev))
        fi = fg_model.to(torch.int32)
        votes = (((fg_model[:, xl] & left_ok).to(torch.int32) + (fg_model[:, xr] & right_ok).to(torch.int32))
                 + F.pad(fi, (0, 0, 1, 0))[:gh][:, xm]) + F.pad(fi, (0, 0, 0, 1))[1:][:, xm]
        grid_fg = torch.where(direct, fg_model[:, xm], votes > 1)

        # model row y -> mask row y + 3, col x + 2 (the reference's placement)
        mask = torch.zeros((h, w), dtype=torch.uint8, device=dev)
        ph = min(gh, h - 3)
        mask[3 : 3 + ph, 2 : 2 + gw] = torch.where(grid_fg[:ph], 255, 0).to(torch.uint8)
        mask = torch.where(t == 0, 0, mask).to(torch.uint8)
        _stage("assembly")
        mask = fill_holes(mask, seed="corner", use_kernels=use_kernels)
        _stage("fill")
        mask = erode(mask, 3)
        _stage("erode")

        st["t"] = t + 1
        st["prev_blue"] = blue
        return st, mask, torch.zeros(frame.shape, dtype=torch.uint8, device=dev)
