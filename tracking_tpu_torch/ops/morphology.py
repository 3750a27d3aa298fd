"""Binary/grayscale morphology and hole filling, counterpart of
``tracking_tpu/ops/morphology.py``.

erode/dilate are min/max over shifted slices of a constant-padded array
(OpenCV's default border: border pixels neither erode nor dilate). Hole
filling is the 4-connected reachability of background pixels from a seed
(``cv::floodFill`` parity), computed by :func:`tracking_tpu_torch.ops.fill.flood_reach`.
"""

from __future__ import annotations

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


def erode(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Erosion with a ksize×ksize rectangle; border value = max (u8 masks)."""
    if img.dtype != torch.uint8:
        raise ValueError("erode takes u8 images")
    return _separable(img, ksize, torch.minimum, 255)


def dilate(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Dilation with a ksize×ksize rectangle; border value = min (u8 masks)."""
    if img.dtype != torch.uint8:
        raise ValueError("dilate takes u8 images")
    return _separable(img, ksize, torch.maximum, 0)


def morph_close(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    return erode(dilate(img, ksize), ksize)


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


def reach_fixpoint(bg: torch.Tensor, reach0: torch.Tensor) -> torch.Tensor:
    """4-connected reachability fixed point (the flood-fill core)."""
    return flood_reach(bg, reach0)
