"""subsenseShrink, counterpart of ``tracking_tpu/bgs/subsense_shrink.py``:
the USTC SuBSENSE with a CIELab "shrink box" overlay.

Before each SuBSENSE step a per-pixel box model (``_yzbx``) makes a
foreground byte map; where that byte reads positive as a signed char
(1..127, the grey box exceedance painted into unstable regions) and the
overlay has run more than 5 frames, the step's sample requirement rises by
5 (the state's ``shrink_req_offset``, read by ``SuBSENSE.step``). Box model:
Lab bounds (±10 on L, ±5 on a/b at frame 0); raw foreground where a channel
leaves its box; FG = close₃(dilate₃(median₉(erode₃(raw)))) with a 3×3
cross; unstable = median₉(any box gap > 30); unstable wide boxes (gap > 10)
shrink by 1 with probability 5/20 while the noise rate is below 0.2; boxes
grow to envelop the input far from the last SuBSENSE mask (a 29×29 max
window) plus a 1/20 ±learnStep margin; the noise rate is re-estimated
every frame.

Plain torch on either device: the module holds no kernel (the SuBSENSE step
under it runs the consensus kernels on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tracking_tpu_torch.bgs.base import State, StepResult
from tracking_tpu_torch.bgs.lbsp_family import SuBSENSE, SuBSENSEConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops import rng
from tracking_tpu_torch.ops.consensus import recip
from tracking_tpu_torch.ops.filters import binary_median_blur
from tracking_tpu_torch.ops.morphology import _reduce_axis, dilate, erode, morph_close
from tracking_tpu_torch.ops.xla_math import powf as _powf

_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)  # MORPH_ELLIPSE 3×3
_F32 = np.float32


def _c(x: float) -> float:
    return float(_F32(x))


# XLA folds the reference's constant chains before it runs them: x / 255 /
# 12.92 becomes x · (f32(1/255) · f32(1/12.92)), 7.787 · (X / 0.950456)
# becomes X · (7.787 · f32(1/0.950456)) and l · 255 / 100 becomes l · 2.55,
# each product of constants rounded to f32. The port multiplies by the same
# folded constants.
_INV255 = recip(255.0)
_LIN = _c(_F32(_INV255) * _F32(recip(12.92)))
_INV1055 = recip(1.055)
_INV_XN = recip(0.950456)
_INV_ZN = recip(1.088754)
_K_X = _c(_F32(7.787) * _F32(_INV_XN))
_K_Z = _c(_F32(7.787) * _F32(_INV_ZN))
_L_SCALE = _c(_F32(255.0) * _F32(recip(100.0)))


def _rgb2lab_u8(img: torch.Tensor) -> torch.Tensor:
    """OpenCV CV_RGB2Lab on u8 [..., 3] with channel 0 taken as R (the
    reference feeds BGR through an RGB conversion), sRGB inverse gamma
    first (``subsense_shrink.py:47-82``). ``cbrt`` is XLA's
    ``pow(|t|, f32(1/3))``."""
    f32 = torch.float32

    def gam(u8):
        v = u8.to(f32)
        c = v * _INV255
        return torch.where(c <= 0.04045, v * _LIN, _powf((c + 0.055) * _INV1055, 2.4))

    r, g, b = (gam(img[..., i]) for i in range(3))
    X = 0.412453 * r + 0.357580 * g + 0.180423 * b
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    Z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    x, z = X * _INV_XN, Z * _INV_ZN
    thr = 0.008856
    k = 16.0 / 116.0

    def cbrt(t):
        return _powf(t, 1.0 / 3.0)

    fx = torch.where(x > thr, cbrt(x), X * _K_X + k)
    fy = torch.where(y > thr, cbrt(y), 7.787 * y + k)
    fz = torch.where(z > thr, cbrt(z), Z * _K_Z + k)
    lum = torch.where(y > thr, 116.0 * cbrt(y) - 16.0, 903.3 * y)
    a = 500.0 * (fx - fy) + 128.0
    bb = 200.0 * (fy - fz) + 128.0
    out = [torch.clamp(torch.round(lum * _L_SCALE), 0, 255), torch.clamp(torch.round(a), 0, 255),
           torch.clamp(torch.round(bb), 0, 255)]
    return torch.stack(out, -1).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class SuBSENSEShrinkConfig(SuBSENSEConfig):
    learnStep: int = 3  # subsenseshrink.h:63


@register("subsenseShrink", aliases=("subsense-shrink", "yzbx"))
class SuBSENSEShrink(SuBSENSE):
    """SuBSENSE with the USTC shrink-box requirement overlay."""

    Config = SuBSENSEShrinkConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        st = super().init(h, w, c, device=device)
        st["box_up"] = torch.zeros((h, w, 3), dtype=torch.uint8, device=device)
        st["box_down"] = torch.zeros((h, w, 3), dtype=torch.uint8, device=device)
        st["yzbx_noise_rate"] = torch.full((), 0.2, dtype=torch.float32, device=device)
        st["yzbx_t"] = torch.zeros((), dtype=torch.int32, device=device)
        st["yzbx_key"] = rng.prng_key(11, device=device)
        return st

    def _yzbx(self, state: State, frame: torch.Tensor):
        """The box model (``subsense_shrink.py:103-179``): (output byte map,
        the box leaves of the next state)."""
        cfg = self.config
        f3 = frame if frame.ndim == 3 else frame[..., None].expand(*frame.shape, 3)
        h, w = f3.shape[:2]
        dev = frame.device
        i32 = torch.int32
        lab = _rgb2lab_u8(f3).to(i32)
        t = state["yzbx_t"]
        keys = rng.split(state["yzbx_key"], 8)
        first = t == 0

        margin = torch.tensor([10, 5, 5], dtype=i32, device=dev)
        up = torch.where(first, torch.clamp(lab + margin, 0, 255), state["box_up"].to(i32))
        down = torch.where(first, torch.clamp(lab - margin, 0, 255), state["box_down"].to(i32))

        gap = torch.clamp(up - down, min=0) // 2
        bg = ((lab <= up) & (lab >= down)).all(dim=-1)
        raw = torch.where(bg, 0, 255).to(torch.uint8)
        # saturated box exceedance -> grey (subsenseshrink.cpp:577-584)
        dif = torch.clamp(torch.clamp(lab - up, min=0) + torch.clamp(down - lab, min=0), 0, 255).to(torch.float32)
        graydif = torch.clamp(torch.round(0.299 * dif[..., 0] + 0.587 * dif[..., 1] + 0.114 * dif[..., 2]), 0, 255)
        graydif = graydif.to(torch.uint8)

        fg = erode(raw, se=_CROSS)
        fg = binary_median_blur(fg, 9)
        fg = dilate(fg, se=_CROSS)
        fg = morph_close(fg, se=_CROSS)
        fg_b = fg > 0

        unstable_raw = torch.where((gap > 30).any(dim=-1), 255, 0).to(torch.uint8)
        unstable = binary_median_blur(unstable_raw, 9) > 0

        # shrink wide unstable boxes while the noise rate is low (:613-620)
        shrinkable = unstable[..., None] & (gap > 10)
        r = rng.randint(keys[1], (h, w, 3), 0, 20)
        do_shrink = (state["yzbx_noise_rate"] < 0.2) & shrinkable & (r < 5)
        up = torch.where(do_shrink, up - 1, up)
        down = torch.where(do_shrink, down + 1, down)

        # grow the boxes far from the last SuBSENSE mask (:632-655); the
        # reference's 30×30 ellipse dilation is a 29×29 max window here, as
        # in the JAX package
        last_fg = (state["last_final"] > 0).to(i32)
        near = _reduce_axis(_reduce_axis(last_fg, 29, 0, torch.maximum, 0), 29, 1, torch.maximum, 0)
        far = (near == 0)[..., None]
        up = torch.where(far, torch.maximum(up, lab), up)
        down = torch.where(far, torch.minimum(down, lab), down)
        r2 = rng.randint(keys[2], (h, w, 3), 0, 20)
        up = torch.where(far & (r2 < 1), torch.maximum(up, lab - cfg.learnStep), up)
        r3 = rng.randint(keys[3], (h, w, 3), 0, 20)
        down = torch.where(far & (r3 < 1), torch.minimum(down, lab + cfg.learnStep), down)

        raw_un = ((raw > 0) & unstable).sum(dtype=i32)
        fg_un = (fg_b & unstable).sum(dtype=i32)
        un = unstable.sum(dtype=i32)
        denom = (un - fg_un).to(torch.float32)
        noise_rate = torch.where(denom > 0, (raw_un - fg_un).to(torch.float32) / denom, state["yzbx_noise_rate"])

        out = torch.where(fg_b & unstable, graydif, raw)
        out = torch.where(first, torch.zeros_like(out), out)
        box_state = {
            "box_up": torch.clamp(up, 0, 255).to(torch.uint8),
            "box_down": torch.clamp(down, 0, 255).to(torch.uint8),
            "yzbx_noise_rate": torch.where(first, torch.full_like(noise_rate, 0.2), noise_rate),
            "yzbx_t": t + 1,
            "yzbx_key": keys[0],
        }
        return out, box_state

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """The box model, then SuBSENSE's step with the raised requirement
        map (``subsense_shrink.py:181-192``)."""
        shrink_fg, box_state = self._yzbx(state, frame)
        # signed-char read: only bytes 1..127 count as positive (:243-246)
        positive = (shrink_fg >= 1) & (shrink_fg <= 127)
        offset = torch.where(positive & (state["yzbx_t"] > 5), 5, 0).to(torch.int32)
        new_state, fg, bg = super().step(dict(state, shrink_req_offset=offset), frame, use_kernels=use_kernels)
        new_state.update(box_state)
        return new_state, fg, bg
