"""Bilinear resize, counterpart of ``jax.image.resize(img, shape,
"bilinear")`` (antialiased: a downscale widens the triangle kernel).

The weights are ``jax._src.image.scale.compute_weight_mat``'s, computed in
f32 in its order of operations as XLA:CPU runs them when the shapes are
static: the inverse scale is the Python double ``1 / (out / in)`` rounded
to f32, the division of the distances by the kernel scale is the product
by its f32 reciprocal, and each column of weights is normalised by its sum
as XLA:CPU adds it (windows of 32 along an axis longer than 32, zero-padded
on both sides, the lower side the smaller half; then the window sums). The
two contractions (rows, then columns) are ``torch.matmul``: XLA:CPU's dot
sums in blocks of its own, so the products agree with it bit for bit at
small sizes (the tests' shapes) and to the last bits at 720p, where a
0/255 map enlarged by an integer factor and rounded is still exact.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_F32 = np.float32
_WINDOW = 32


def _column_sum(w: np.ndarray) -> np.ndarray:
    """Σ over axis 0 of [m, n] f32 in XLA:CPU's order."""
    m = w.shape[0]
    if m <= _WINDOW:
        s = np.zeros(w.shape[1], _F32)
        for k in range(m):
            s = (s + w[k]).astype(_F32)
        return s
    pad = -(-m // _WINDOW) * _WINDOW - m
    x = np.concatenate([np.zeros((pad // 2, w.shape[1]), _F32), w, np.zeros((pad - pad // 2, w.shape[1]), _F32)])
    return _column_sum(np.stack([_column_sum(x[b : b + _WINDOW]) for b in range(0, x.shape[0], _WINDOW)]))


@lru_cache(maxsize=None)
def weight_mat(m: int, n: int) -> np.ndarray:
    """[m, n] f32: weight of input index k in output index i (triangle
    kernel, antialiased)."""
    inv = _F32(1.0 / (n / m))
    ks = max(inv, _F32(1.0))
    rks = _F32(1.0) / ks
    sample = (np.arange(n, dtype=_F32) + _F32(0.5)) * inv + _F32(-0.5)
    x = np.abs(sample[None, :] - np.arange(m, dtype=_F32)[:, None]) * rks
    w = np.maximum(_F32(0.0), _F32(1.0) - np.abs(x))
    tot = _column_sum(w)[None]
    w = np.where(np.abs(tot) > _F32(1000.0 * np.finfo(np.float32).eps), w / np.where(tot != 0, tot, _F32(1.0)),
                 _F32(0.0))
    inside = (sample >= _F32(-0.5)) & (sample <= _F32(m - 0.5))
    return np.where(inside[None], w, _F32(0.0)).astype(_F32)


@lru_cache(maxsize=None)
def _on(m: int, n: int, rows: bool, device: str) -> torch.Tensor:
    w = weight_mat(m, n)
    return torch.from_numpy(np.ascontiguousarray(w.T if rows else w)).to(device)


def resize_bilinear(img: torch.Tensor, shape) -> torch.Tensor:
    """f32 [H, W] -> f32 ``shape`` (an axis of equal size is left alone,
    as ``jax.image.resize`` skips it)."""
    if img.dtype != torch.float32 or img.ndim != 2:
        raise ValueError(f"resize_bilinear takes an f32 [H, W] image, got {img.dtype} {tuple(img.shape)}")
    (h, w), (oh, ow) = img.shape, shape
    out = img
    if oh != h:
        out = _on(h, oh, True, str(img.device)) @ out
    if ow != w:
        out = out @ _on(w, ow, False, str(img.device))
    return out
