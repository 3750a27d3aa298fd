"""GMG (type 8), counterpart of ``tracking_tpu/bgs/gmg.py``
(Godbehere, Matsukawa and Goldberg 2012, as OpenCV 2.4's
``BackgroundSubtractorGMG``).

Each pixel keeps a move-to-front list of ≤ ``maxFeatures`` quantised colour
codes with weights. The first ``initializationFrames`` frames only count
(the mask stays empty); afterwards a pixel is foreground where the
posterior of its matched weight says so, and the 0/255 mask is
median-smoothed with ``smoothingRadius``. The background image is zeros
(OpenCV 2.4 does not implement it). The list update is the CUDA kernel
``gmg_step`` on CUDA tensors (it updates the banks in place);
``step(..., use_kernels=False)`` runs its plain version.
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops.filters import binary_median_blur
from tracking_tpu_torch.ops.gmg import gmg_step, gmg_step_ref


@dataclasses.dataclass(frozen=True)
class GMGConfig(BGSConfig):
    initializationFrames: int = 20
    decisionThreshold: float = 0.7
    showOutput: bool = True
    # OpenCV 2.4 defaults (not exposed by the reference's XML):
    maxFeatures: int = 64
    learningRate: float = 0.025
    quantizationLevels: int = 16
    backgroundPrior: float = 0.8
    smoothingRadius: int = 7


def _quantize(frame: torch.Tensor, levels: int) -> torch.Tensor:
    """[H, W(, C)] u8 -> [H, W] packed quantised colour code, int32 (the
    reference's u32 code: torch's uint32 has no ``+`` or ``//``, so the
    arithmetic runs in int64)."""
    f = frame if frame.ndim == 3 else frame[..., None]
    q = (f.to(torch.int64) * levels) // 256
    code = torch.zeros(f.shape[:2], dtype=torch.int64, device=frame.device)
    for c in range(f.shape[-1]):
        code = code * levels + q[..., c]
    return code.to(torch.int32)


@register("GMG", type_id=8, aliases=("gmg",))
class GMG(BGSAlgorithm):
    Config = GMGConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        K = self.config.maxFeatures
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            # u32 codes; empty slots hold the sentinel 0xFFFFFFFF
            "colors": torch.full((K, h, w), -1, dtype=torch.int32, device=device).view(torch.uint32),
            "weights": torch.zeros((K, h, w), dtype=torch.float32, device=device),
            "nf": torch.zeros((h, w), dtype=torch.int32, device=device),
        }

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        cfg = self.config
        t = state["t"]
        code = _quantize(frame, cfg.quantizationLevels)
        fn = gmg_step if use_kernels else gmg_step_ref
        fg_raw, nf1, colors, weights = fn(
            code, state["nf"], state["colors"].view(torch.int32), state["weights"], t,
            lr=cfg.learningRate, prior=cfg.backgroundPrior, thr=cfg.decisionThreshold,
            init_frames=cfg.initializationFrames,
        )
        fg = fg_raw.to(torch.uint8)
        if cfg.smoothingRadius > 0:
            fg = binary_median_blur(fg, cfg.smoothingRadius)
        bg = torch.zeros(frame.shape, dtype=torch.uint8, device=frame.device)
        return {"t": t + 1, "colors": colors.view(torch.uint32), "weights": weights, "nf": nf1}, fg, bg
