"""IMBS (ustc type 33, Bloisi and Iocchi's Independent Multimodal BGS),
counterpart of ``tracking_tpu/bgs/imbs.py`` (``db/imbs.{hpp,cpp}``, wrapper
``IndependentMultimodalBGS.cpp``).

Per frame the timestamp advances by 1000 / fps ms. Once a model exists:
getFg (a pixel is FG unless a non-FG model bin lies within fgThreshold;
a match with an FG bin first is PERSISTENCE), the HSV shadow test, and
filterFg (hard foreground components smaller than minArea, or of 60 % of
the frame or more, are dropped; the component areas come from the CUDA
labelling kernel ``ops/cc.label_components`` on the card). Then updateBg:
every samplingPeriod ms a sample joins the per-pixel bins (integer
re-average of the first matching or empty bin), and at the numSamples-th
sample the bins are promoted to the model (the running-maximum bin kept
at slot 0). Labels: SHADOW 80, PERSISTENCE 180, FOREGROUND 255. Every
quirk of the JAX package's module doc is kept: association scans only
slots below the sample number, a stale bin value can match, the promotion
displaces the previous front into the current slot, getFg keeps scanning
after a non-FG match, a sudden change (over 50 % FG) halves the sampling
period and rebuilds with numSamples / 3 samples, the last sample of a
model repeats the stored one.

The JAX package branches with ``lax.cond`` on its 0-d state (detection
once a model exists, the sample, its first slot, the promotion); the port
reads those four flags on the host with one synchronisation a frame and
runs only the branch taken. The promotion walk, a per-pixel ``fori_loop``
under ``vmap`` in the JAX package, is a loop over the numSamples bins of
whole-map operations; it runs once per model build. The bins update in
place (``step`` consumes its state). Float order as XLA:CPU runs the JAX
code: ``x / 255`` is the product by f32(1/255), the HSV's divisions by
tensors divide.
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops.cc import label_components, label_components_ref
from tracking_tpu_torch.ops.consensus import recip
from tracking_tpu_torch.ops.morphology import morph_close, morph_open

SHADOW_LABEL = 80
PERSISTENCE_LABEL = 180
FOREGROUND_LABEL = 255


def _rgb_to_hsv_full(bgr_u8: torch.Tensor) -> torch.Tensor:
    """IMBS's own full-range HSV (H, S, V in 0..255; ``imbs.cpp:540-666``)
    of [..., 3] u8 BGR."""
    dev = bgr_u8.device
    f32 = torch.float32
    b, g, r = (bgr_u8[..., i].to(f32) * recip(255.0) for i in range(3))
    mx = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    d = mx - mn
    one = torch.ones((), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    safe = torch.where(d == 0, one, d * 6.0)
    # the reference's integer comparisons decide ties: B < G < R
    bi, gi, ri = (bgr_u8[..., i].to(torch.int32) for i in range(3))
    mxi = torch.maximum(torch.maximum(bi, gi), ri)
    is_r = mxi == ri
    is_g = (mxi == gi) & ~is_r
    h = torch.where(is_r, (g - b) / safe, torch.where(is_g, (b - r) / safe + 2.0 / 6.0, (r - g) / safe + 4.0 / 6.0))
    h = torch.where(h < 0, h + 1.0, h)
    h = torch.where(h >= 1.0, h - 1.0, h)
    s = torch.where(mxi == 0, zero, d / torch.where(mx == 0, one, mx))
    h = torch.where(mxi == 0, zero, h)

    def to_u8(x):
        return torch.clamp((x * 255.0 + 0.5).to(torch.int32), 0, 255).to(torch.uint8)

    return torch.stack([to_u8(h), to_u8(s), to_u8(mx)], dim=-1)


def _cheby(a_u8: torch.Tensor, b_u8: torch.Tensor) -> torch.Tensor:
    """Chebyshev (largest channel) distance over the trailing axis, int32."""
    return (a_u8.to(torch.int32) - b_u8.to(torch.int32)).abs().amax(dim=-1)


def _prefix_all(valid: torch.Tensor) -> torch.Tensor:
    """[M, ...] bool -> True where every slot up to and including this one is."""
    return torch.cumprod(valid.to(torch.int32), dim=0) > 0


def _none_before(x: torch.Tensor) -> torch.Tensor:
    """[M, ...] bool -> True where no earlier slot is."""
    seen = torch.cumsum(x.to(torch.int32), dim=0) - x.to(torch.int32)
    return seen == 0


@dataclasses.dataclass(frozen=True)
class IMBSConfig(BGSConfig):
    fps: float = 10.0
    fgThreshold: int = 15
    associationThreshold: int = 5
    samplingPeriod: float = 500.0
    minBinHeight: int = 2
    numSamples: int = 30
    alpha: float = 0.65
    beta: float = 1.15
    tau_s: float = 60.0
    tau_h: float = 40.0
    minArea: float = 30.0
    persistencePeriod: float = 10000.0
    morphologicalFiltering: bool = False
    showOutput: bool = True


@register("IndependentMultimodalBGS", type_id=33, aliases=("imbs",))
class IMBS(BGSAlgorithm):
    Config = IMBSConfig

    @property
    def _max_bins(self) -> int:
        return self.config.numSamples // self.config.minBinHeight

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        S, M = self.config.numSamples, self._max_bins
        kw = dict(device=device)
        u8, i32, f32, b = torch.uint8, torch.int32, torch.float32, torch.bool
        return {
            "t": torch.zeros((), dtype=i32, **kw),
            "bins_val": torch.zeros((S, h, w, 3), dtype=u8, **kw),
            "bins_h": torch.zeros((S, h, w), dtype=i32, **kw),
            "bins_fg": torch.zeros((S, h, w), dtype=b, **kw),
            "model_val": torch.zeros((M, h, w, 3), dtype=u8, **kw),
            "model_hsv": torch.zeros((M, h, w, 3), dtype=u8, **kw),
            "model_valid": torch.zeros((M, h, w), dtype=b, **kw),
            "model_fg": torch.zeros((M, h, w), dtype=b, **kw),
            "model_cnt": torch.zeros((M, h, w), dtype=i32, **kw),
            "persistence": torch.zeros((h, w), dtype=f32, **kw),
            "model_ready": torch.zeros((), dtype=b, **kw),
            "timestamp": torch.zeros((), dtype=f32, **kw),
            "prev_bg_frame_time": torch.zeros((), dtype=f32, **kw),
            "bg_frame_counter": torch.zeros((), dtype=i32, **kw),
            "num_samples_cur": torch.full((), self.config.numSamples, dtype=i32, **kw),
            "sampling_period_cur": torch.full((), self.config.samplingPeriod, dtype=f32, **kw),
            "bg_reset": torch.zeros((), dtype=b, **kw),
            "sudden_change": torch.zeros((), dtype=b, **kw),
            "bg_sample": torch.zeros((h, w, 3), dtype=u8, **kw),
        }

    def _get_fg(self, st, frame):
        """getFg (imbs.cpp:452-509): (label, persistence, model_fg)."""
        cfg = self.config
        vp = _prefix_all(st["model_valid"])
        within = (_cheby(st["model_val"], frame[None]) < cfg.fgThreshold) & vp
        fg_match = within & st["model_fg"]
        exists_a = fg_match.any(dim=0)
        nonfg_match = (within & ~st["model_fg"] & _none_before(fg_match)).any(dim=0)
        is_fg = vp[0] & ~nonfg_match
        label = torch.where(is_fg, torch.where(exists_a, PERSISTENCE_LABEL, FOREGROUND_LABEL), 0).to(torch.uint8)
        pers = st["persistence"]
        pers = torch.where(nonfg_match | (label == FOREGROUND_LABEL), 0.0, pers)
        pers = torch.where(label == PERSISTENCE_LABEL, pers + 1000.0 / cfg.fps, pers)
        clear = pers > cfg.persistencePeriod
        model_fg = torch.where(clear[None] & vp, False, st["model_fg"])
        return label, pers, model_fg

    def _hsv_suppress(self, st, frame, label):
        """hsvSuppression (imbs.cpp:243-293)."""
        cfg = self.config
        hsv_i = _rgb_to_hsv_full(frame).to(torch.int32)
        hsv_b = st["model_hsv"].to(torch.int32)
        eligible = _prefix_all(st["model_valid"]) & ~st["model_fg"]
        h_abs = (hsv_i[None, ..., 0] - hsv_b[..., 0]).abs()
        h_diff = torch.minimum(h_abs, 255 - h_abs)
        s_diff = (hsv_i[None, ..., 1] - hsv_b[..., 1]).abs()
        v_b = hsv_b[..., 2].to(torch.float32)
        tiny = torch.full((), 1e-6, dtype=torch.float32, device=frame.device)
        v_ratio = hsv_i[None, ..., 2].to(torch.float32) / torch.where(v_b == 0, tiny, v_b)
        shadow = (eligible & (h_diff <= cfg.tau_h) & (s_diff <= cfg.tau_s) & (v_ratio >= cfg.alpha)
                  & (v_ratio < cfg.beta)).any(dim=0)
        return torch.where((label > 0) & shadow, SHADOW_LABEL, label).to(torch.uint8)

    def _filter_fg(self, label, use_kernels: bool):
        """filterFg (imbs.cpp:672-707): (label, sudden change)."""
        cfg = self.config
        h, w = label.shape
        n = h * w
        hard = torch.where(label == FOREGROUND_LABEL, 255, 0).to(torch.uint8)
        sudden = (hard > 0).sum() > 0.5 * h * w
        if cfg.morphologicalFiltering:
            hard = morph_close(morph_open(hard, 3), 3)
        lab = (label_components if use_kernels else label_components_ref)(hard, 8)
        idx = torch.where(lab >= 0, lab, n).reshape(-1).long()
        areas = torch.zeros(n + 1, dtype=torch.int32, device=label.device)
        areas.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
        px_area = areas[idx].reshape(h, w)
        keep = (lab >= 0) & (px_area >= cfg.minArea) & (px_area < 0.6 * n)
        out = torch.where(keep, 255, 0)
        out = torch.where(label == PERSISTENCE_LABEL, PERSISTENCE_LABEL, out)
        out = torch.where(label == SHADOW_LABEL, SHADOW_LABEL, out)
        return out.to(torch.uint8), sudden

    def _associate(self, st, k: int, sample, fgmask):
        """createBg's bin association (imbs.cpp:295-361) of sample number
        ``k``; updates the bins in place."""
        cfg = self.config
        bv, bh, bf = st["bins_val"], st["bins_h"], st["bins_fg"]
        is_fg_px = fgmask == FOREGROUND_LABEL
        if k == 0:  # slot 0 seeded, the other heights zeroed, stale values and isFg kept
            bv[0] = sample
            bh.zero_()
            bh[0] = 1
            bf[0] = is_fg_px
            return
        # only slots below k take part
        val, hgt, fgs = bv[:k], bh[:k], bf[:k]
        match = _cheby(val, sample[None]) <= cfg.associationThreshold
        cand = match | (hgt == 0)
        sel = cand & _none_before(cand)  # the first candidate
        is_match = (sel & match).any(dim=0)
        avg = ((val.to(torch.int32) * hgt[..., None] + sample[None].to(torch.int32))
               // (hgt + 1)[..., None]).to(torch.uint8)
        new_val = torch.where(sel[..., None], torch.where(is_match[..., None], avg, sample[None]), val)
        # isFg: a match only sets it; a new bin sets it either way
        new_fg = torch.where(sel, torch.where(is_match, fgs | is_fg_px, is_fg_px), fgs)
        bv[:k] = new_val
        bh[:k] = torch.where(sel, hgt + 1, hgt)
        bf[:k] = new_fg

    def _promote(self, st, fgmask):
        """createBg's promotion (imbs.cpp:363-431): the walk over the bins,
        per pixel, as whole-map operations a bin at a time. Returns
        (model_val, model_valid, model_fg, model_cnt, bins_fg)."""
        cfg = self.config
        M = self._max_bins
        bins_val, bins_h = st["bins_val"], st["bins_h"]
        bins_fg = st["bins_fg"].clone()
        m_val, m_valid = st["model_val"], st["model_valid"]
        m_fg, m_cnt = st["model_fg"], st["model_cnt"]
        persist_px = fgmask == PERSISTENCE_LABEL
        dev = fgmask.device
        mslot = torch.arange(M, device=dev)[:, None, None]
        idx = torch.zeros(fgmask.shape, dtype=torch.int32, device=dev)
        max_h = torch.full(fgmask.shape, -1, dtype=torch.int32, device=dev)
        stopped = torch.zeros(fgmask.shape, dtype=torch.bool, device=dev)
        for s in range(cfg.numSamples):
            h_s, val_s = bins_h[s], bins_val[s]
            at_idx = mslot == idx[None]
            stop_now = ~stopped & (h_s == 0)
            m_valid = torch.where(stop_now[None] & at_idx, False, m_valid)  # the end marker
            stopped = stopped | stop_now | (idx >= M)
            accept = ~stopped & (h_s >= cfg.minBinHeight)
            # persistence fix: clear matching model isFg and this bin's isFg
            pfix = accept & persist_px
            hit = _prefix_all(m_valid) & (_cheby(m_val, val_s[None]) < cfg.fgThreshold) & pfix[None]
            m_fg = torch.where(hit, False, m_fg)
            bin_fg_s = bins_fg[s] & ~(pfix & hit.any(dim=0))
            bins_fg[s] = bin_fg_s
            # the displaced front goes to slot idx, a new maximum to slot 0
            is_new_max = accept & (h_s > max_h)
            put = at_idx & accept[None]
            m_val = torch.where(put[..., None], torch.where(is_new_max[..., None], m_val[0], val_s)[None], m_val)
            m_fg = torch.where(put, torch.where(is_new_max, m_fg[0], bin_fg_s)[None], m_fg)
            m_cnt = torch.where(put, torch.where(is_new_max, m_cnt[0], h_s)[None], m_cnt)
            m_valid = m_valid | put
            front = (mslot == 0) & is_new_max[None]
            m_val = torch.where(front[..., None], val_s[None], m_val)
            m_fg = torch.where(front, bin_fg_s[None], m_fg)
            m_cnt = torch.where(front, h_s[None], m_cnt)
            m_valid = m_valid | front
            idx = torch.where(accept, idx + 1, idx)
            max_h = torch.where(is_new_max, h_s, max_h)
        # a walk through all bins without an empty one writes no end marker
        return m_val, m_valid, m_fg, m_cnt, bins_fg

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame. ``use_kernels=False`` labels the components with the
        plain version on the card too."""
        cfg = self.config
        f3 = frame if frame.ndim == 3 else frame[..., None].expand(*frame.shape, 3)
        h, w = f3.shape[:2]
        st = dict(state)
        st["timestamp"] = st["timestamp"] + 1000.0 / cfg.fps

        # changeBg (imbs.cpp:190-192, 709-724)
        do_change = st["sudden_change"] & ~st["bg_reset"]
        st["num_samples_cur"] = torch.where(do_change, st["num_samples_cur"] // 3, st["num_samples_cur"])
        st["sampling_period_cur"] = torch.where(do_change, st["sampling_period_cur"] * 0.5, st["sampling_period_cur"])
        st["bg_frame_counter"] = torch.where(do_change, 0, st["bg_frame_counter"]).to(torch.int32)
        st["bg_reset"] = st["bg_reset"] | do_change
        cnt = torch.where(st["bg_reset"], torch.minimum(st["bg_frame_counter"], st["num_samples_cur"] - 1),
                          st["bg_frame_counter"])
        pbt = torch.minimum(st["prev_bg_frame_time"], st["timestamp"])
        is_last_t = cnt == st["num_samples_cur"] - 1
        take_t = is_last_t | ((st["timestamp"] - pbt) >= st["sampling_period_cur"])
        # the branches' flags, one synchronisation
        ready, take, is_last, k = torch.stack([st["model_ready"].to(torch.int32), take_t.to(torch.int32),
                                               is_last_t.to(torch.int32), cnt]).tolist()

        if ready:
            label, st["persistence"], st["model_fg"] = self._get_fg(st, f3)
            label = self._hsv_suppress(st, f3, label)
            label, sudden = self._filter_fg(label, use_kernels)
            st["sudden_change"] = st["sudden_change"] | sudden
        else:
            label = torch.zeros((h, w), dtype=torch.uint8, device=frame.device)

        # updateBg (imbs.cpp:209-234); the last sample of a model reuses the
        # stored one (the reference copies the frame only on the gated path)
        if take:
            if not is_last:
                st["bg_sample"] = f3.clone()
                st["prev_bg_frame_time"] = st["timestamp"]
            else:
                st["prev_bg_frame_time"] = pbt
            self._associate(st, k, st["bg_sample"], label)
            if is_last:
                m_val, m_valid, m_fg, m_cnt, bins_fg = self._promote(st, label)
                st.update(bins_fg=bins_fg, model_val=m_val, model_valid=m_valid, model_fg=m_fg, model_cnt=m_cnt,
                          model_hsv=_rgb_to_hsv_full(m_val), persistence=torch.zeros_like(st["persistence"]))
                sudden = st["sudden_change"]
                st["bg_reset"] = torch.zeros_like(st["bg_reset"])
                st["num_samples_cur"] = torch.where(
                    sudden, torch.clamp(st["num_samples_cur"] * 3, max=cfg.numSamples), st["num_samples_cur"])
                st["sampling_period_cur"] = torch.where(sudden, st["sampling_period_cur"] * 2.0,
                                                        st["sampling_period_cur"])
                st["sudden_change"] = torch.zeros_like(sudden)
                st["model_ready"] = torch.ones_like(st["model_ready"])
                st["bg_frame_counter"] = torch.zeros_like(st["bg_frame_counter"])
            else:
                st["bg_frame_counter"] = (cnt + 1).to(torch.int32)
        else:
            st["bg_frame_counter"] = cnt.to(torch.int32)
            st["prev_bg_frame_time"] = pbt
        st["t"] = state["t"] + 1

        bg = torch.where(st["model_valid"][0][..., None], st["model_val"][0], 0).to(torch.uint8)
        if frame.ndim == 2:
            bg = bg[..., 0]
        return st, label, bg
