"""The dp-package BGS family (Donovan Parks' mini-framework, SURVEY §2.3),
counterpart of ``tracking_tpu/bgs/dp.py``: DPAdaptiveMedianBGS (type 9),
DPMeanBGS (12) and DPWrenGABGS (13).

The reference wrappers (``dp/DPAdaptiveMedianBGS.cpp:29-80``) run
``Subtract`` with the pre-update model, clear the low mask, then
``Update``: every update is unconditional, and the emitted mask is the
high-threshold one (2 × threshold). Each model is a per-pixel recurrence;
the JAX package runs them with XLA ops and no Pallas code, so they are
plain torch here on every device. The median steps on int16 views, as the
reference does; the float models compute in f32 in the reference's order
(each ``** 2`` one product, channel sums left to right).
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register


def _ensure_3ch(frame: torch.Tensor) -> torch.Tensor:
    """dp models are defined over channels; grey gets a channel axis."""
    return frame if frame.ndim == 3 else frame[..., None]


def _channel_sq_sum(d: torch.Tensor) -> torch.Tensor:
    """Σ_c d[..., c]² in channel order (XLA's reduce over the last axis)."""
    total = d[..., 0] * d[..., 0]
    for ci in range(1, d.shape[-1]):
        total = total + d[..., ci] * d[..., ci]
    return total


def _round_u8(x: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """The model image as u8: + 0.5, clipped, truncated (the reference's
    cast after the clip); grey frames drop the channel axis."""
    bg = torch.clamp(x + 0.5, 0.0, 255.0).to(torch.uint8)
    return bg if frame.ndim == 3 else bg[..., 0]


@dataclasses.dataclass(frozen=True)
class DPAdaptiveMedianConfig(BGSConfig):
    threshold: int = 40
    samplingRate: int = 7
    learningFrames: int = 30
    showOutput: bool = True


@register("DPAdaptiveMedianBGS", type_id=9, aliases=("adaptive-median",))
class DPAdaptiveMedian(BGSAlgorithm):
    """Per-pixel ±1 running median (McFarlane & Schofield,
    ``dp/AdaptiveMedianBGS.cpp:63-111``): background where every channel
    differs by at most 2 × threshold; the median steps towards the frame
    on every samplingRate-th frame."""

    Config = DPAdaptiveMedianConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "median": torch.zeros((h, w, max(c, 1)), dtype=torch.uint8, device=device),
        }

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels`` is accepted for the common step
        signature; this algorithm has no kernel)."""
        cfg = self.config
        t = state["t"]
        f = _ensure_3ch(frame)
        median = self._first_frame_select(t, state["median"], f)
        m16, f16 = median.to(torch.int16), f.to(torch.int16)
        high_bg = ((m16 - f16).abs() <= 2 * cfg.threshold).all(dim=-1)
        fg = torch.where(high_bg, 0, 255).to(torch.uint8)
        stepped = torch.clamp(m16 + torch.sign(f16 - m16), 0, 255).to(torch.uint8)
        new_median = torch.where((t % cfg.samplingRate) == 1, stepped, median)
        bg = new_median if frame.ndim == 3 else new_median[..., 0]
        return {"t": t + 1, "median": new_median}, fg, bg


@dataclasses.dataclass(frozen=True)
class DPMeanConfig(BGSConfig):
    threshold: int = 2700
    alpha: float = 1e-6
    learningFrames: int = 30
    showOutput: bool = True


@register("DPMeanBGS", type_id=12, aliases=("dp-mean",))
class DPMean(BGSAlgorithm):
    """FG where Σ_c (I − μ)² > 2 × threshold; μ ← α·μ + (1 − α)·I, the old
    mean weighted by α as in ``dp/MeanBGS.cpp:68``."""

    Config = DPMeanConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "mean": torch.zeros((h, w, max(c, 1)), dtype=torch.float32, device=device),
        }

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        cfg = self.config
        t = state["t"]
        f = _ensure_3ch(frame).to(torch.float32)
        mean = torch.where(t == 0, f, state["mean"])
        dist = _channel_sq_sum(f - mean)
        fg = torch.where(dist > 2.0 * cfg.threshold, 255, 0).to(torch.uint8)
        new_mean = mean * cfg.alpha + f * (1.0 - cfg.alpha)
        return {"t": t + 1, "mean": new_mean}, fg, _round_u8(new_mean, frame)


@dataclasses.dataclass(frozen=True)
class DPWrenGAConfig(BGSConfig):
    threshold: float = 12.25
    alpha: float = 0.005
    learningFrames: int = 30
    showOutput: bool = True


@register("DPWrenGABGS", type_id=13, aliases=("wren-ga",))
class DPWrenGA(BGSAlgorithm):
    """One Gaussian a pixel with a scalar variance (Wren's Pfinder,
    ``dp/WrenGA.cpp:47-172``): FG where ‖I − μ‖² > 2·thr·σ²; μ ← μ − α(μ − I),
    σ² ← σ² + α(‖I − μ‖² − σ²) clamped to [4, 180]."""

    Config = DPWrenGAConfig

    INIT_VARIANCE = 36.0  # WrenGA.cpp:51

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "mu": torch.zeros((h, w, max(c, 1)), dtype=torch.float32, device=device),
            "var": torch.full((h, w), self.INIT_VARIANCE, dtype=torch.float32, device=device),
        }

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        cfg = self.config
        t = state["t"]
        f = _ensure_3ch(frame).to(torch.float32)
        mu = torch.where(t == 0, f, state["mu"])
        var = state["var"]
        delta = mu - f
        dist = _channel_sq_sum(delta)
        fg = torch.where(dist > var * (2.0 * cfg.threshold), 255, 0).to(torch.uint8)
        new_mu = mu - delta * cfg.alpha
        new_var = torch.clamp(var + (dist - var) * cfg.alpha, 4.0, 5.0 * self.INIT_VARIANCE)
        return {"t": t + 1, "mu": new_mu, "var": new_var}, fg, _round_u8(new_mu, frame)
