"""VuMeter (ustc type 31, Robinault & Vacavant's per-pixel intensity
histogram), counterpart of ``tracking_tpu/bgs/vumeter.py``.

Per grey pixel a 256 / binSize-bin histogram decays by alpha each frame
and the current intensity's bin gains 1 − alpha; FG where that bin's mass
is below the threshold; the background pixel is replaced by the current
one when the current bin outweighs the background pixel's bin
(``av/TBackgroundVuMeter.cpp:260-319``, wrapper ``av/VuMeter.cpp:33-85``).
The first 5 frames give empty masks; ``enableFilter`` erodes and
median-blurs the mask. The wrapper's ``CV_RGB2GRAY`` on BGR data swaps the
R and B weights, and so does :func:`_swapped_gray`.

The JAX package sums the one-hot selects over the bins; exactly one term
is nonzero, so that sum is the selected bin's mass itself, which the port
reads with a gather. The JAX package has no Pallas code for this model,
so it is plain torch on every device.
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops.filters import binary_median_blur
from tracking_tpu_torch.ops.morphology import erode


def _swapped_gray(frame: torch.Tensor) -> torch.Tensor:
    """``cvtColor(CV_RGB2GRAY)`` of BGR data: Q15 Rec.601 luma with the R
    weight on B and the B weight on R."""
    if frame.ndim == 2:
        return frame
    b, g, r = (frame[..., i].to(torch.int32) for i in range(3))
    return ((b * 9798 + g * 19235 + r * 3735 + (1 << 14)) >> 15).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class VuMeterConfig(BGSConfig):
    enableFilter: bool = True
    binSize: int = 8
    alpha: float = 0.995
    threshold: float = 0.03
    showOutput: bool = True


@register("VuMeter", type_id=31, aliases=("vumeter",))
class VuMeter(BGSAlgorithm):
    Config = VuMeterConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        bins = 256 // self.config.binSize
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "hist": torch.zeros((bins, h, w), dtype=torch.float32, device=device),
            "bg": torch.zeros((h, w), dtype=torch.uint8, device=device),
        }

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels`` is accepted for the common step
        signature; this algorithm has no kernel)."""
        cfg = self.config
        bins = 256 // cfg.binSize
        gray = _swapped_gray(frame)
        t = state["t"]
        bg = self._first_frame_select(t, state["bg"], gray)

        def bin_of(img):
            return torch.clamp(img.to(torch.int64) // cfg.binSize, 0, bins - 1)[None]

        cur = bin_of(gray)
        onehot = cur == torch.arange(bins, device=gray.device)[:, None, None]
        hist = state["hist"] * cfg.alpha + torch.where(onehot, 1.0 - cfg.alpha, 0.0).to(torch.float32)
        cur_mass = hist.gather(0, cur)[0]
        fg = torch.where(cur_mass < cfg.threshold, 255, 0).to(torch.uint8)
        new_bg = torch.where(hist.gather(0, bin_of(bg))[0] < cur_mass, gray, bg)

        fg = torch.where(t + 1 < 5, 0, fg).to(torch.uint8)  # m_nCount < 5 (:314-315)
        if cfg.enableFilter:
            fg = binary_median_blur(erode(fg, 3), 5)
        return {"t": t + 1, "hist": hist, "bg": new_bg}, fg, new_bg
