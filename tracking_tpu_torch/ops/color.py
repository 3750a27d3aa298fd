"""Colour and dtype conversions matching OpenCV's arithmetic, counterpart of
``tracking_tpu/ops/color.py``: ``cvtColor(BGR2GRAY)`` in Q15 fixed point,
``convertTo`` to and from unit floats, ``absdiff``."""

from __future__ import annotations

import numpy as np
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


def fold(*constants: float) -> float:
    """A chain of constant factors as XLA folds it at compile time: each
    rounded to f32, multiplied in f32 from the left (``x * a * b`` runs as
    ``x * f32(a·b)``)."""
    p = np.float32(constants[0])
    for c in constants[1:]:
        p = np.float32(p * np.float32(c))
    return float(p)


def to_unit_f32(img_u8: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """u8 -> f32 in [0, 1]: ``convertTo(CV_32F, 1./255.)``, the product by
    f32(1/255); times ``weight`` as the reference's jitted ``weight *
    to_unit_f32(img)`` runs, one product by the folded constant."""
    return img_u8.to(torch.float32) * fold(1.0 / 255.0, weight)


def to_u8(img_f: torch.Tensor, scale: float = 255.0) -> torch.Tensor:
    """f32 -> u8 as ``saturate_cast(cvRound(x * scale))``: round half to
    even, then clamp."""
    return torch.clamp(torch.round(img_f * scale), 0.0, 255.0).to(torch.uint8)


def absdiff_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``cv::absdiff`` of u8 operands (exact, no wraparound)."""
    return (a.to(torch.int16) - b.to(torch.int16)).abs().to(torch.uint8)
