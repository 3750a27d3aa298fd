"""The simple temporal BGS family, counterpart of ``tracking_tpu/bgs/simple.py``:
FrameDifferenceBGS (type 0), StaticFrameDifferenceBGS (1),
WeightedMovingMeanBGS (2), WeightedMovingVarianceBGS (3),
AdaptiveBackgroundLearning (6) and AdaptiveSelectiveBackgroundLearning (7),
the reference's ``package_bgs/`` root wrappers (SURVEY §2.2).

Each is a per-pixel recurrence with O(1) state a pixel, in plain torch (the
JAX package has no Pallas code for them). The float ones compute in f32 as
the reference's jitted step does on XLA:CPU: a weight times a unit-scaled
frame is one product by the folded constant f32(f32(1/255)·w)
(``ops/color.fold``), the division by 3 and the scale to u8 fold into one
product by f32(f32(1/3)·255) = 85, ``1 - alpha`` is taken in f64 and
rounded once, and square roots are correctly rounded
(``ops/xla_math.sqrt``). Effective parameter defaults are the reference's
``loadConfig`` defaults.
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops.color import absdiff_u8, bgr2gray_u8, fold, to_u8, to_unit_f32
from tracking_tpu_torch.ops.consensus import recip
from tracking_tpu_torch.ops.filters import binary_median_blur
from tracking_tpu_torch.ops.threshold import threshold_binary
from tracking_tpu_torch.ops.xla_math import sqrt


def _mask_from_diff(diff_u8: torch.Tensor, enable_threshold: bool, threshold: int) -> torch.Tensor:
    """absdiff image -> grey -> optional binary threshold (the shared tail
    of every simple wrapper, e.g. ``FrameDifferenceBGS.cpp:45-51``)."""
    g = bgr2gray_u8(diff_u8)
    if enable_threshold:
        g = threshold_binary(g, threshold)
    return g


def _zeros(shape, device, dtype=torch.uint8) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def _image_shape(h: int, w: int, c: int):
    return (h, w, c) if c > 1 else (h, w)


def _blank_before(t: torch.Tensor, n: int, fg: torch.Tensor) -> torch.Tensor:
    """No mask before frame ``n`` (the reference's warm-up returns)."""
    return torch.where(t < n, torch.zeros_like(fg), fg)


@dataclasses.dataclass(frozen=True)
class FrameDifferenceConfig(BGSConfig):
    enableThreshold: bool = True
    threshold: int = 15
    showOutput: bool = True


@register("FrameDifferenceBGS", type_id=0, aliases=("framediff",))
class FrameDifference(BGSAlgorithm):
    """fg_t = |frame_t − frame_{t−1}| > threshold (``FrameDifferenceBGS.cpp:
    29-61``). The first frame emits no mask."""

    Config = FrameDifferenceConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        return {"t": _zeros((), device, torch.int32), "prev": _zeros(_image_shape(h, w, c), device)}

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels`` is accepted for the common step
        signature; this algorithm has no kernel)."""
        cfg = self.config
        t, prev = state["t"], state["prev"]
        fg = _mask_from_diff(absdiff_u8(prev, frame), cfg.enableThreshold, cfg.threshold)
        return {"t": t + 1, "prev": frame}, _blank_before(t, 1, fg), prev


@dataclasses.dataclass(frozen=True)
class StaticFrameDifferenceConfig(BGSConfig):
    enableThreshold: bool = True
    threshold: int = 15
    showOutput: bool = True


@register("StaticFrameDifferenceBGS", type_id=1, aliases=("staticdiff",))
class StaticFrameDifference(BGSAlgorithm):
    """fg_t = |frame_t − frame_0| > threshold, the first frame as the
    background (``StaticFrameDifferenceBGS.cpp:29-57``)."""

    Config = StaticFrameDifferenceConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        return {"t": _zeros((), device, torch.int32), "bg": _zeros(_image_shape(h, w, c), device)}

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        cfg = self.config
        t = state["t"]
        bg = self._first_frame_select(t, state["bg"], frame)
        fg = _mask_from_diff(absdiff_u8(frame, bg), cfg.enableThreshold, cfg.threshold)
        return {"t": t + 1, "bg": bg}, fg, bg


@dataclasses.dataclass(frozen=True)
class WeightedMovingMeanConfig(BGSConfig):
    enableWeight: bool = True
    enableThreshold: bool = True
    threshold: int = 15
    showOutput: bool = True
    showBackground: bool = False


@register("WeightedMovingMeanBGS", type_id=2, aliases=("wmovmean",))
class WeightedMovingMean(BGSAlgorithm):
    """bg = 0.5·I_t + 0.3·I_{t−1} + 0.2·I_{t−2} in unit-scale f32, rounded
    to u8; fg = |I_t − bg| > threshold (``WeightedMovingMeanBGS.cpp:29-96``).
    The first two frames emit no mask."""

    Config = WeightedMovingMeanConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        shape = _image_shape(h, w, c)
        return {"t": _zeros((), device, torch.int32), "prev1": _zeros(shape, device), "prev2": _zeros(shape, device)}

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        cfg = self.config
        t, p1, p2 = state["t"], state["prev1"], state["prev2"]
        if cfg.enableWeight:
            bg = to_u8(to_unit_f32(frame, 0.5) + to_unit_f32(p1, 0.3) + to_unit_f32(p2, 0.2))
        else:
            bg = to_u8(to_unit_f32(frame) + to_unit_f32(p1) + to_unit_f32(p2), fold(recip(3.0), 255.0))
        fg = _mask_from_diff(absdiff_u8(frame, bg), cfg.enableThreshold, cfg.threshold)
        return {"t": t + 1, "prev1": frame, "prev2": p1}, _blank_before(t, 2, fg), bg


@dataclasses.dataclass(frozen=True)
class WeightedMovingVarianceConfig(BGSConfig):
    enableWeight: bool = True
    enableThreshold: bool = True
    threshold: int = 15
    showOutput: bool = True


@register("WeightedMovingVarianceBGS", type_id=3, aliases=("wmovvar",))
class WeightedMovingVariance(BGSAlgorithm):
    """fg = round(255·sqrt(Σ wᵢ(Iᵢ − μ_w)²)) > threshold over a 3-frame
    window (``WeightedMovingVarianceBGS.cpp:30-117``); the unweighted
    branch's weights are 0.3/0.3/0.3, as the reference's. Masks start at
    frame 2."""

    Config = WeightedMovingVarianceConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        shape = _image_shape(h, w, c)
        return {"t": _zeros((), device, torch.int32), "prev1": _zeros(shape, device), "prev2": _zeros(shape, device)}

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        cfg = self.config
        t, p1, p2 = state["t"], state["prev1"], state["prev2"]
        f, f1, f2 = to_unit_f32(frame), to_unit_f32(p1), to_unit_f32(p2)
        w0, w1, w2 = (0.5, 0.3, 0.2) if cfg.enableWeight else (0.3, 0.3, 0.3)
        mean = to_unit_f32(frame, w0) + to_unit_f32(p1, w1) + to_unit_f32(p2, w2)

        def sq(x):
            a = (x - mean).abs()
            return a * a

        var = w0 * sq(f) + w1 * sq(f1) + w2 * sq(f2)
        fg = _mask_from_diff(to_u8(sqrt(var)), cfg.enableThreshold, cfg.threshold)
        return {"t": t + 1, "prev1": frame, "prev2": p1}, _blank_before(t, 2, fg), to_u8(mean)


@dataclasses.dataclass(frozen=True)
class AdaptiveBackgroundLearningConfig(BGSConfig):
    alpha: float = 0.05
    limit: int = -1
    enableThreshold: bool = True
    threshold: int = 15
    showForeground: bool = True
    showBackground: bool = True


def _blend(alpha: float, frame: torch.Tensor, bg: torch.Tensor) -> torch.Tensor:
    """α·f + (1 − α)·bg of two u8 images in unit-scale f32, each a product
    by a folded constant; 1 − α is taken in f64 and rounded once."""
    return to_unit_f32(frame, alpha) + to_unit_f32(bg, 1.0 - alpha)


@register("AdaptiveBackgroundLearning", type_id=6, aliases=("adaptive",))
class AdaptiveBackgroundLearning(BGSAlgorithm):
    """Running-average background bg <- α·I + (1−α)·bg, rounded to u8 each
    frame; fg = |I − bg before the update| > threshold
    (``AdaptiveBackgroundLearning.cpp:30-83``). With ``limit > 0`` the
    reference's counter never moves, so the background stays frame 0's;
    only ``limit == -1`` learns."""

    Config = AdaptiveBackgroundLearningConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        return {"t": _zeros((), device, torch.int32), "bg": _zeros(_image_shape(h, w, c), device)}

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        cfg = self.config
        t = state["t"]
        bg = self._first_frame_select(t, state["bg"], frame)
        f, bg_f = to_unit_f32(frame), to_unit_f32(bg)
        new_bg = to_u8(_blend(cfg.alpha, frame, bg)) if cfg.limit == -1 else bg
        fg = _mask_from_diff(to_u8((f - bg_f).abs()), cfg.enableThreshold, cfg.threshold)
        return {"t": t + 1, "bg": new_bg}, fg, new_bg


@dataclasses.dataclass(frozen=True)
class AdaptiveSelectiveConfig(BGSConfig):
    learningFrames: int = 90
    alphaLearn: float = 0.05
    alphaDetection: float = 0.05
    threshold: int = 25
    showOutput: bool = True


@register("AdaptiveSelectiveBackgroundLearning", type_id=7, aliases=("adaptive-selective",))
class AdaptiveSelectiveBackgroundLearning(BGSAlgorithm):
    """Grey running average with a learning phase, then updates only where
    the median-filtered mask says background
    (``AdaptiveSelectiveBackgroundLearning.cpp:31-131``)."""

    Config = AdaptiveSelectiveConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        return {
            "t": _zeros((), device, torch.int32),
            "counter": _zeros((), device, torch.int32),
            "bg": _zeros((h, w), device),
        }

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        cfg = self.config
        t, counter = state["t"], state["counter"]
        gray = bgr2gray_u8(frame)
        bg = self._first_frame_select(t, state["bg"], gray)
        f, bg_f = to_unit_f32(gray), to_unit_f32(bg)
        fg = binary_median_blur(threshold_binary(to_u8((f - bg_f).abs()), cfg.threshold), 3)
        in_learning = (counter <= cfg.learningFrames) & (cfg.learningFrames > 0)
        detect_bg = torch.where(fg == 0, _blend(cfg.alphaDetection, gray, bg), bg_f)
        new_bg = to_u8(torch.where(in_learning, _blend(cfg.alphaLearn, gray, bg), detect_bg))
        new_counter = counter + in_learning.to(torch.int32)
        return {"t": t + 1, "counter": new_counter, "bg": new_bg}, fg, new_bg
