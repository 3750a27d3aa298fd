"""DPTextureBGS (type 16), counterpart of ``tracking_tpu/bgs/texture.py``
(Heikkilä and Pietikäinen's LBP texture histograms, ``dp/TextureBGS``).

Per frame: a 6-point LBP code image per channel (radius 2, hysteresis 3,
2-px border zeroed); per pixel and channel the 64-bin histogram of the codes
in the 11×11 window; the histogram intersection with the model, foreground
where it is below 181.5 inside the 7-px valid region; then the model blend
``rint(0.05·cur + 0.95·model)`` where the TRANSPOSED mask is background (the
reference reads ``fgMask(x, y)``), frozen where the transposed index
leaves the image. The histograms and the intersection are the CUDA kernel
``texture_prox_cur`` on CUDA tensors; ``step(..., use_kernels=False)`` runs
its plain version. The background image is zeros, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops.lbsp import edge_pad
from tracking_tpu_torch.ops.texture import NUM_BINS, REGION_R, region_hist, texture_prox_cur, texture_prox_cur_ref

TEXTURE_R = 2
HYSTERSIS = 3
ALPHA = 0.05
BORDER = REGION_R + TEXTURE_R  # 7

# (drow, dcol, bit), TextureBGS.cpp:28-53
_LBP_OFFSETS = ((-2, 0, 1), (-1, -2, 2), (-1, 2, 4), (1, -2, 8), (1, 2, 16), (2, 0, 32))


def lbp6(plane: torch.Tensor) -> torch.Tensor:
    """[H, W] u8 -> [H, W] u8 LBP code (``texture._lbp6``); the 2-px border
    stays 0."""
    h, w = plane.shape
    c = plane.to(torch.int32)
    p = edge_pad(c, TEXTURE_R, TEXTURE_R, TEXTURE_R, TEXTURE_R)
    code = torch.zeros((h, w), dtype=torch.int32, device=plane.device)
    for dr, dc, bit in _LBP_OFFSETS:
        nb = p[TEXTURE_R + dr : TEXTURE_R + dr + h, TEXTURE_R + dc : TEXTURE_R + dc + w]
        code = code + torch.where(c - nb + HYSTERSIS >= 0, bit, 0)
    out = torch.zeros((h, w), dtype=torch.uint8, device=plane.device)
    out[TEXTURE_R : h - TEXTURE_R, TEXTURE_R : w - TEXTURE_R] = code[TEXTURE_R : h - TEXTURE_R, TEXTURE_R : w - TEXTURE_R].to(torch.uint8)
    return out


def _valid(h: int, w: int, device) -> torch.Tensor:
    valid = torch.zeros((h, w), dtype=torch.bool, device=device)
    valid[BORDER : h - BORDER, BORDER : w - BORDER] = True
    return valid


def _three(frame: torch.Tensor) -> torch.Tensor:
    return frame if frame.ndim == 3 else frame[..., None].expand(*frame.shape, 3)


@dataclasses.dataclass(frozen=True)
class DPTextureConfig(BGSConfig):
    # The reference exposes only enableFiltering (dead code) + showOutput.
    showOutput: bool = True


@register("DPTextureBGS", type_id=16, aliases=("texture-lbp", "dp-texture"))
class DPTextureBGS(BGSAlgorithm):
    Config = DPTextureConfig
    THRESHOLD = 0.5 * (2 * REGION_R + 1) ** 2 * 3  # TextureBGS.h:27

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "model": torch.zeros((3, NUM_BINS, h, w), dtype=torch.uint8, device=device),
        }

    @staticmethod
    def _codes(f3: torch.Tensor) -> torch.Tensor:
        return torch.stack([lbp6(f3[..., ch]) for ch in range(3)])

    def warm_start(self, state: State, frame: torch.Tensor) -> State:
        """Seed the model with the first frame's own histograms inside the
        valid region (``DPTextureBGS.cpp:72-90``)."""
        f3 = _three(frame)
        h, w = f3.shape[:2]
        cur = torch.stack([region_hist(c) for c in self._codes(f3)])
        return dict(state, model=torch.where(_valid(h, w, frame.device)[None, None], cur, 0))

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        f3 = _three(frame)
        h, w = f3.shape[:2]
        valid = _valid(h, w, frame.device)
        model = state["model"]
        fn = texture_prox_cur if use_kernels else texture_prox_cur_ref
        prox, cur = fn(self._codes(f3), model)
        fg = torch.where((prox < self.THRESHOLD) & valid, 255, 0).to(torch.uint8)

        # transposed-mask update: pixel (y, x) learns where mask[x, y] == 0;
        # a transposed index outside the image freezes the pixel
        p = max(h, w)
        padded = torch.full((p, p), 255, dtype=torch.uint8, device=frame.device)
        padded[:h, :w] = fg
        upd = ((padded.T[:h, :w] == 0) & valid).contiguous()  # row-major, so the model stays row-major
        blended = torch.clamp(torch.round(ALPHA * cur.to(torch.float32) + (1 - ALPHA) * model.to(torch.float32)), 0, 255)
        model = torch.where(upd[None, None], blended.to(torch.uint8), model)
        bg = torch.zeros(frame.shape, dtype=torch.uint8, device=frame.device)
        return {"t": state["t"] + 1, "model": model}, fg, bg
