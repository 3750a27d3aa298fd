"""FGD and FGDSimple, the tracking app's FG_0 / FG_0S detectors, counterpart
of ``tracking_tpu/bgs/fgd.py`` (Li, Huang, Gu and Tian 2003; OpenCV legacy
``CV_BG_MODEL_FGD`` / ``_FGD_SIMPLE``, re-derived with OpenCV's parameter
struct).

Per frame: ``changed`` where any channel moved more than ``delta`` levels
since the last frame (never on the first); the colour key (C channels
quantised to ``Lc`` levels) and the co-occurrence key (the last and this
frame quantised to ``Lcc``); the Bayes-table phase (``ops/fgd.py``: the
CUDA kernel ``fgd_tables`` on CUDA tensors, which updates the tables in
place, or its plain version with ``step(..., use_kernels=False)``); then
the mask: ``perform_morphing`` opens (a 3×3 erode, then dilate), the
border-seeded hole fill and the ``minArea`` gate on the 64 largest
components. The background image is an ``alpha1`` running average over the
pixels labelled background (incl. absorbed ones), rounded half to even.
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops.cc import area_gate
from tracking_tpu_torch.ops.fgd import fgd_tables, fgd_tables_ref, quant
from tracking_tpu_torch.ops.morphology import dilate, erode, fill_holes


@dataclasses.dataclass(frozen=True)
class FGDConfig(BGSConfig):
    # CvFGDStatModelParams defaults (cvaux/include legacy header)
    Lc: int = 128
    N1c: int = 15
    N2c: int = 25
    Lcc: int = 64
    N1cc: int = 25
    N2cc: int = 40
    is_obj_without_holes: bool = True
    perform_morphing: int = 1
    alpha1: float = 0.1
    alpha2: float = 0.005
    alpha3: float = 0.1
    delta: float = 2.0
    T: float = 0.9
    minArea: float = 15.0
    # a pixel foreground this many frames in a row is labelled background
    # for the updates (the paper's absorption of repetitive motion)
    absorbFrames: int = 30
    showOutput: bool = True


@register("FGD", aliases=("FG_0", "fgd"))
class FGD(BGSAlgorithm):
    """FG_0: the full FGD model."""

    Config = FGDConfig

    # storage dtype of the P / Pb statistics (arithmetic is f32 either way);
    # float16 as in the reference, float32 also works
    STAT_DTYPE = torch.float16

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        cfg = self.config
        c = max(c, 1)

        def z8(n, k):
            return torch.zeros((n, k, h, w), dtype=torch.uint8, device=device)

        def zf(n):
            return torch.zeros((n, h, w), dtype=self.STAT_DTYPE, device=device)

        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "prev": torch.zeros((c, h, w), dtype=torch.uint8, device=device),
            "bg": torch.zeros((c, h, w), dtype=torch.uint8, device=device),
            "ct_key": z8(cfg.N2c, c),
            "ct_P": zf(cfg.N2c),
            "ct_Pb": zf(cfg.N2c),
            "cc_key": z8(cfg.N2cc, 2 * c),
            "cc_P": zf(cfg.N2cc),
            "cc_Pb": zf(cfg.N2cc),
            "fg_age": torch.zeros((h, w), dtype=torch.int32, device=device),
        }

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        cfg = self.config
        planes = tuple(frame[..., ci] for ci in range(frame.shape[-1])) if frame.ndim == 3 else (frame,)
        c = len(planes)
        t = state["t"]
        prev = tuple(state["prev"][ci] for ci in range(c))

        diff_big = torch.zeros(planes[0].shape, dtype=torch.bool, device=frame.device)
        for ci in range(c):
            d = (planes[ci].to(torch.int32) - prev[ci].to(torch.int32)).abs()
            diff_big = diff_big | (d > cfg.delta)
        changed = diff_big & (t > 0)
        ckey = torch.stack(quant(planes, cfg.Lc))
        cckey = torch.stack(quant(prev, cfg.Lcc) + quant(planes, cfg.Lcc))
        first = t == 0

        tables_fn = fgd_tables if use_kernels else fgd_tables_ref
        updates, is_bg, lab_bg = tables_fn(cfg, state, ckey, cckey, changed, first)

        fg = torch.where(is_bg, 0, 255).to(torch.uint8)
        for _ in range(cfg.perform_morphing):
            fg = dilate(erode(fg, 3), 3)  # open: kill specks
        if cfg.is_obj_without_holes:
            filled = fill_holes(fg, seed="border", use_kernels=use_kernels)
            fg = torch.where(filled > 0, 255, 0).to(torch.uint8)
        if cfg.minArea > 0:
            fg = area_gate(fg, cfg.minArea, max_blobs=64, use_kernels=use_kernels)

        new_bg = []
        for ci in range(c):
            old = state["bg"][ci]
            blend = torch.round((1.0 - cfg.alpha1) * old.to(torch.float32) + cfg.alpha1 * planes[ci].to(torch.float32))
            v = torch.where(lab_bg, blend.to(torch.uint8), old)
            new_bg.append(torch.where(first, planes[ci], v))
        new_state = {"t": t + 1, "prev": torch.stack(planes), "bg": torch.stack(new_bg), **updates}
        bg_img = new_state["bg"].permute(1, 2, 0).contiguous() if frame.ndim == 3 else new_state["bg"][0]
        return new_state, fg, bg_img


@register("FGDSimple", aliases=("FG_0S", "fgd-simple"))
class FGDSimple(FGD):
    """FG_0S: the simplified-parameter FGD variant (no morphing cycle)."""

    @dataclasses.dataclass(frozen=True)
    class Config(FGDConfig):
        perform_morphing: int = 0
