"""Binary/grayscale morphology and hole filling, counterpart of
``tracking_tpu/ops/morphology.py``.

erode/dilate are min/max over shifted slices of a constant-padded array
(OpenCV's default border: border pixels neither erode nor dilate). Hole
filling is the 4-connected reachability of background pixels from a seed
(``cv::floodFill`` parity), computed by :func:`tracking_tpu_torch.ops.fill.flood_reach`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tracking_tpu_torch.ops.fill import flood_reach, flood_reach_ref


def _reduce_axis(img: torch.Tensor, k: int, axis: int, reducer, pad_value: int) -> torch.Tensor:
    r = k // 2
    n = img.shape[axis]
    pad = (0, 0, r, r) if axis == img.ndim - 2 else (r, r)
    x = F.pad(img, pad, mode="constant", value=pad_value)
    out = None
    for i in range(k):
        v = x.narrow(axis, i, n)
        out = v if out is None else reducer(out, v)
    return out


def _separable(img: torch.Tensor, ksize: int, reducer, pad_value: int) -> torch.Tensor:
    h_ax, w_ax = img.ndim - 2, img.ndim - 1
    return _reduce_axis(_reduce_axis(img, ksize, h_ax, reducer, pad_value), ksize, w_ax, reducer, pad_value)


def _shift_reduce(img: torch.Tensor, se: np.ndarray, reducer, pad_value: int) -> torch.Tensor:
    """Reduce over the structuring element's set positions: shifted slices
    of the constant-padded image, in row-major SE order."""
    kh, kw = se.shape
    H, W = img.shape[-2], img.shape[-1]
    x = F.pad(img, (kw // 2, kw // 2, kh // 2, kh // 2), mode="constant", value=pad_value)
    out = None
    for dy in range(kh):
        for dx in range(kw):
            if se[dy, dx]:
                v = x[..., dy : dy + H, dx : dx + W]
                out = v if out is None else reducer(out, v)
    return out


def _morph(img: torch.Tensor, ksize: int, se, reducer, pad_value: int, name: str) -> torch.Tensor:
    if img.dtype != torch.uint8:
        raise ValueError(f"{name} takes u8 images")
    if se is None:
        return _separable(img, ksize, reducer, pad_value)
    se = np.asarray(se, dtype=bool)
    if se.all() and se.shape[0] == se.shape[1] and min(se.shape) > 1:
        return _separable(img, se.shape[0], reducer, pad_value)
    return _shift_reduce(img, se, reducer, pad_value)


def erode(img: torch.Tensor, ksize: int = 3, se=None) -> torch.Tensor:
    """Erosion with a ksize×ksize rectangle or the boolean structuring
    element ``se`` (such as subsenseShrink's 3×3 cross); border value = max
    (u8 masks)."""
    return _morph(img, ksize, se, torch.minimum, 255, "erode")


def dilate(img: torch.Tensor, ksize: int = 3, se=None) -> torch.Tensor:
    """Dilation with a ksize×ksize rectangle or ``se``; border value = min
    (u8 masks)."""
    return _morph(img, ksize, se, torch.maximum, 0, "dilate")


def morph_open(img: torch.Tensor, ksize: int = 3, se=None) -> torch.Tensor:
    return dilate(erode(img, ksize, se), ksize, se)


def morph_close(img: torch.Tensor, ksize: int = 3, se=None) -> torch.Tensor:
    return erode(dilate(img, ksize, se), ksize, se)


def fill_holes(mask_u8: torch.Tensor, seed: str = "border", use_kernels: bool = True) -> torch.Tensor:
    """Fill background regions unreachable from the seed through background
    pixels (4-connectivity). seed="corner": only pixel (0, 0), SuBSENSE's
    ``cv::floodFill(mask, Point(0,0), 255)``; seed="border": every border
    pixel. ``use_kernels=False`` takes the plain reachability even on the
    card."""
    fg = mask_u8 > 0
    seeds = torch.zeros_like(fg)
    if seed == "corner":
        seeds[0, 0] = True
    elif seed == "border":
        seeds[0, :] = True
        seeds[-1, :] = True
        seeds[:, 0] = True
        seeds[:, -1] = True
    else:
        raise ValueError(f"unknown seed {seed!r}")
    bg = ~fg
    reach_fn = flood_reach if use_kernels else flood_reach_ref
    reach = reach_fn(bg, seeds & bg)
    filled = fg | ~reach
    return torch.where(filled, 255, 0).to(torch.uint8)


def reach_fixpoint(bg: torch.Tensor, reach0: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
    """4-connected reachability fixed point (the flood-fill core).
    ``use_kernels=False`` takes the plain reachability even on the card."""
    return (flood_reach if use_kernels else flood_reach_ref)(bg, reach0)
