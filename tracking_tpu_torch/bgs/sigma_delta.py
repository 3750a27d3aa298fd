"""SigmaDeltaBGS (type 35), counterpart of ``tracking_tpu/bgs/sigma_delta.py``
(Manzanera and Richefeu's sigma-delta estimation, ``package_bgs/bl/
sdLaMa091.cpp``).

Per byte: M <- M ± 1 toward I; O = |M − I| with the stepped M; V <- V ± 1
toward ampFactor·O, stepped in u8 (255 + 1 wraps to 0) and then clamped to
[minVar, maxVar]; a channel fires where O ≥ V, and a pixel where any
channel fires (``sdLaMa091.cpp:596-630``). The first frame only sets M = I
and emits no mask. torch's CPU uint8 has few operators, so the arithmetic
runs on int16 / int32 and the state stays u8.
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register


@dataclasses.dataclass(frozen=True)
class SigmaDeltaConfig(BGSConfig):
    ampFactor: int = 1
    minVar: int = 15
    maxVar: int = 255
    showOutput: bool = True


@register("SigmaDeltaBGS", type_id=35, aliases=("sigma-delta",))
class SigmaDelta(BGSAlgorithm):
    Config = SigmaDeltaConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        shape = (h, w, c) if c > 1 else (h, w)
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "M": torch.zeros(shape, dtype=torch.uint8, device=device),
            "V": torch.full(shape, self.config.minVar, dtype=torch.uint8, device=device),
        }

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        cfg = self.config
        t = state["t"]
        M = self._first_frame_select(t, state["M"], frame)
        V = state["V"]
        fi, Mi = frame.to(torch.int16), M.to(torch.int16)
        # M steps toward I first; O uses the stepped M
        M2 = Mi + torch.sign(fi - Mi)
        O = (M2 - fi).abs().to(torch.int32)
        Vi = V.to(torch.int32)
        V2 = torch.clamp((Vi + torch.sign(cfg.ampFactor * O - Vi)) & 0xFF, cfg.minVar, cfg.maxVar)
        seg = torch.where(O < V2, 0, 255).to(torch.uint8)
        fg = seg.amax(dim=-1) if frame.ndim == 3 else seg
        first = t == 0
        fg = torch.where(first, torch.zeros_like(fg), fg)
        # frame 0 only initialises M (V untouched)
        new_M = torch.where(first, M, M2.to(torch.uint8))
        new_V = torch.where(first, V, V2.to(torch.uint8))
        return {"t": t + 1, "M": new_M, "V": new_V}, fg, M
