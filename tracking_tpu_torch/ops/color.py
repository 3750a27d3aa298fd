"""Colour conversion matching OpenCV's integer arithmetic, counterpart of
``tracking_tpu/ops/color.py``."""

from __future__ import annotations

import torch

# OpenCV Rec.601 Q15 fixed-point luma coefficients, B, G, R order
_B_Q15 = 3735
_G_Q15 = 19235
_R_Q15 = 9798
_HALF_Q15 = 1 << 14


def bgr2gray_u8(img: torch.Tensor) -> torch.Tensor:
    """BGR u8 [..., H, W, 3] -> grey u8 [..., H, W], bit-exact with
    ``cv::cvtColor(BGR2GRAY)``: (B·3735 + G·19235 + R·9798 + 2¹⁴) >> 15.
    A grey [..., H, W] or [..., H, W, 1] input passes through."""
    if img.ndim >= 3 and img.shape[-1] == 3:
        b, g, r = (img[..., i].to(torch.int32) for i in range(3))
        return ((b * _B_Q15 + g * _G_Q15 + r * _R_Q15 + _HALF_Q15) >> 15).to(torch.uint8)
    if img.ndim >= 3 and img.shape[-1] == 1:
        return img[..., 0]
    return img
