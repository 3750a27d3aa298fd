"""Fuzzy-integral fusion BGS (ustc types 21 and 22), counterpart of
``tracking_tpu/bgs/fuzzy.py``: FuzzySugenoIntegral and FuzzyChoquetIntegral
(``tb/FuzzySugenoIntegral.cpp:30-176``, ``tb/FuzzyChoquetIntegral.cpp``).

On float frames in [0, 1]: for the first framesToLearn frames the
background learns at alphaLearn (the first frame is copied) and the mask
is empty; afterwards the texture similarity (fuzzy LBP ratio of the grey
images) and the colour similarities feed a fuzzy integral, a pixel is FG
where the (optionally 3x3 median-smoothed) integral is at most the
threshold, and the background updates adaptively-selectively from the
frame-wide integral minimum and maximum. Measures g: option 1 (0.4, 0.3,
0.3), option 2 (0.6, 0.3, 0.1); Sugeno keeps option 2's criteria layout
for option 1 too (the reference's quirk).

Float order as XLA:CPU runs the JAX code: ``x / 255`` is the product by
f32(1/255), and the weighted frames ``alphaLearn * f`` and ``alphaUpdate *
f`` are one product of the u8 frame by the folded constant
(``ops/color.fold``); the update's ``beta_lin`` divides by a device
tensor. The JAX package has no Pallas code for these models, so they are
plain torch on every device.
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops.color import fold, to_unit_f32
from tracking_tpu_torch.ops.filters import median_blur
from tracking_tpu_torch.ops.fuzzy import (
    choquet_integral, color_convert_f32, fuzzy_lbp, similarity_ratio, sugeno_integral,
)


def _gray_f32(bgr_f: torch.Tensor) -> torch.Tensor:
    """cv::cvtColor BGR2GRAY on float data."""
    return bgr_f[..., 0] * 0.114 + bgr_f[..., 1] * 0.587 + bgr_f[..., 2] * 0.299


@dataclasses.dataclass(frozen=True)
class FuzzyIntegralConfig(BGSConfig):
    showOutput: bool = True
    framesToLearn: int = 10
    alphaLearn: float = 0.1
    alphaUpdate: float = 0.01
    colorSpace: int = 1  # 1 RGB, 2 Ohta, 3 HSV, 4 YCrCb
    option: int = 2  # 1: 3 colors; 2: 2 colors + texture
    smooth: bool = True
    threshold: float = 0.67


class _FuzzyIntegralBase(BGSAlgorithm):
    Config = FuzzyIntegralConfig
    SUGENO: bool = True

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "bg": torch.zeros((h, w, 3), dtype=torch.float32, device=device),
        }

    def _integral(self, f: torch.Tensor, bg: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h_tex = similarity_ratio(fuzzy_lbp(_gray_f32(f)), fuzzy_lbp(_gray_f32(bg)))
        delta = similarity_ratio(color_convert_f32(f, cfg.colorSpace), color_convert_f32(bg, cfg.colorSpace))
        if self.SUGENO:
            g = (0.4, 0.3, 0.3) if cfg.option == 1 else (0.6, 0.3, 0.1)
            return sugeno_integral(torch.stack([h_tex, delta[..., 0], delta[..., 1]], dim=-1), g)
        if cfg.option == 1:
            return choquet_integral(delta, (0.4, 0.3, 0.3))
        return choquet_integral(torch.stack([h_tex, delta[..., 0], delta[..., 1]], dim=-1), (0.6, 0.3, 0.1))

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        cfg = self.config
        t, bg = state["t"], state["bg"]
        f3 = frame if frame.ndim == 3 else frame[..., None].expand(*frame.shape, 3)
        x = f3.to(torch.float32)
        f = to_unit_f32(f3)
        zero = torch.zeros((), dtype=torch.float32, device=bg.device)

        bg_learn = torch.where(t == 0, f, x * fold(1.0 / 255.0, cfg.alphaLearn) + bg * (1 - cfg.alphaLearn))

        integral = self._integral(f, bg)
        if cfg.smooth:
            integral = median_blur(integral, 3)
        fg = torch.where(integral > cfg.threshold, 0, 255).to(torch.uint8)

        mn, mx = integral.min(), integral.max()
        flat = mn == mx
        beta_lin = torch.where(flat, zero, mn * (integral - mx) / torch.where(flat, torch.ones_like(mn), mn - mx))
        beta = (1.0 - integral + beta_lin)[..., None]
        blended = x * fold(1.0 / 255.0, cfg.alphaUpdate) + bg * (1 - cfg.alphaUpdate)
        bg_detect = beta * bg + (1.0 - beta) * blended

        learning = t <= cfg.framesToLearn
        new_bg = torch.where(learning, bg_learn, bg_detect)
        fg = torch.where(learning, torch.zeros_like(fg), fg)
        bg_u8 = torch.clamp(new_bg * 255.0, 0, 255).to(torch.uint8)
        if frame.ndim == 2:
            bg_u8 = bg_u8[..., 0]
        return {"t": t + 1, "bg": new_bg}, fg, bg_u8


@register("FuzzySugenoIntegral", type_id=21, aliases=("fuzzy-sugeno",))
class FuzzySugenoIntegral(_FuzzyIntegralBase):
    SUGENO = True


@register("FuzzyChoquetIntegral", type_id=22, aliases=("fuzzy-choquet",))
class FuzzyChoquetIntegral(_FuzzyIntegralBase):
    SUGENO = False
