"""Median, Gaussian and box filters, counterpart of
``tracking_tpu/ops/filters.py``."""

from __future__ import annotations

import numpy as np
import torch

from tracking_tpu_torch.ops.lbsp import edge_pad


def binary_median_blur(mask_u8: torch.Tensor, ksize: int) -> torch.Tensor:
    """``cv::medianBlur`` on a strictly binary 0/255 mask [H, W].

    The median of k² binary values (k odd) is the majority vote, so it is
    one windowed count over an edge-replicated border."""
    r = ksize // 2
    H, W = mask_u8.shape
    on = edge_pad((mask_u8 > 0).to(torch.int32), r, r, r, r)
    cnt = on[0:H]
    for dy in range(1, ksize):
        cnt = cnt + on[dy : dy + H]
    out = cnt[:, 0:W]
    for dx in range(1, ksize):
        out = out + cnt[:, dx : dx + W]
    return torch.where(2 * out > ksize * ksize, 255, 0).to(torch.uint8)


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV ``getGaussianKernel`` for sigma > 0: exp(−i²/2σ²), normalised
    in f64 and rounded to f32 (``filters.gaussian_kernel1d``)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    half = (ksize - 1) * 0.5
    xs = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _reflect101(n: int, r: int, device) -> torch.Tensor:
    """Indices of ``BORDER_REFLECT_101`` padding by r on both sides."""
    i = torch.arange(-r, n + r, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _conv1d_axis(img: torch.Tensor, kernel: np.ndarray, axis: int) -> torch.Tensor:
    """1-D correlation along ``axis`` with reflect-101 padding; the terms
    are summed in index order, as the reference's unrolled sum."""
    r = len(kernel) // 2
    n = img.shape[axis]
    x = img.index_select(axis, _reflect101(n, r, img.device))
    out = None
    for i, kv in enumerate(kernel):
        term = x.narrow(axis, i, n) * float(kv)
        out = term if out is None else out + term
    return out


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 1.5) -> torch.Tensor:
    """Separable Gaussian blur over the spatial dims of [..., H, W(, C)]
    (``filters.gaussian_blur``): rows, then columns. u8 in -> f32 math ->
    u8 out (round half to even); float in -> float out."""
    kern = gaussian_kernel1d(ksize, sigma)
    is_u8 = img.dtype == torch.uint8
    x = img.to(torch.float32) if is_u8 else img
    ch_last = img.ndim >= 3 and img.shape[-1] in (1, 3, 4)
    h_ax, w_ax = (img.ndim - 3, img.ndim - 2) if ch_last else (img.ndim - 2, img.ndim - 1)
    x = _conv1d_axis(x, kern, h_ax)
    x = _conv1d_axis(x, kern, w_ax)
    if is_u8:
        return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
    return x


def _window_stack(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """The k×k neighbourhood of each pixel of [..., H, W] over a replicated
    border, stacked along a new leading axis in row-major window order."""
    r = ksize // 2
    H, W = img.shape[-2], img.shape[-1]
    x = edge_pad(img, r, r, r, r)
    return torch.stack([x[..., dy : dy + H, dx : dx + W] for dy in range(ksize) for dx in range(ksize)], dim=0)


def median_blur(img: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """Median filter over [..., H, W] with a replicated border
    (``cv::medianBlur``)."""
    win = _window_stack(img, ksize)
    return torch.sort(win, dim=0).values[(ksize * ksize) // 2].to(img.dtype)


def box_filter(img: torch.Tensor, ksize: int, normalize: bool = True) -> torch.Tensor:
    """Box filter (mean or sum over the k×k window) of [..., H, W] with a
    reflect-101 border, in f32: rows, then columns, each term a product
    by f32(1/k) (or 1) summed in index order."""
    ones = np.ones(ksize, dtype=np.float32)
    if normalize:
        ones /= ksize
    x = _conv1d_axis(img.to(torch.float32), ones, img.ndim - 2)
    return _conv1d_axis(x, ones, img.ndim - 1)
