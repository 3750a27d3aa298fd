"""Bilinear resize, counterpart of ``jax.image.resize(img, shape,
"bilinear")`` (antialiased: a downscale widens the triangle kernel).

The weights are ``jax._src.image.scale.compute_weight_mat``'s, computed in
f32 in its order of operations as XLA:CPU runs them when the shapes are
static: the inverse scale is the Python double ``1 / (out / in)`` rounded
to f32, the division of the distances by the kernel scale is the product
by its f32 reciprocal, and each column of weights is normalised by its sum
as XLA:CPU adds it (windows of 32 along an axis longer than 32, zero-padded
on both sides, the lower side the smaller half; then the window sums).

The resize is one einsum of the image with both weight matrices, which
contracts first the axis that costs fewer multiplies in all (the rows for
a downscale such as LbpMrf's grid, the columns for MultiCue's enlarges).
Its two contractions are XLA ``dot``s, each run by ``ops/contract.contract``
in XLA:CPU's order (``resize_rows_plan``: Eigen's equal slices of at most
320 rows, or its blocks of 96 added in a tree where it shards the rows
over its threads, at 240-576 rows of 320-720 columns; ``resize_cols_plan``:
blocks of 1,024 columns). Only a weight's band of nonzero terms is
visited: a zero term leaves a chain unchanged (the image is finite).

On CUDA tensors each contraction is the kernel ``contract``
(``csrc/contract.cu``); CPU tensors take the plain version.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tracking_tpu_torch.ops.contract import contract, resize_cols_plan, resize_rows_plan

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
def _band(m: int, n: int, device: str):
    """weight_mat(m, n).T on ``device`` (a view, [n, m]) with each output's
    first and last input of nonzero weight (int32 [n]; hi < lo where there
    is none)."""
    w = weight_mat(m, n)
    nz = w != 0
    any_ = nz.any(0)
    lo = np.where(any_, nz.argmax(0), 0).astype(np.int32)
    hi = np.where(any_, m - 1 - nz[::-1].argmax(0), -1).astype(np.int32)
    wt, lo, hi = (torch.from_numpy(np.ascontiguousarray(v)).to(device) for v in (w, lo, hi))
    return wt.T, lo, hi


def resize_bilinear(img: torch.Tensor, shape, use_kernels: bool = True) -> torch.Tensor:
    """f32 [H, W] -> f32 ``shape`` (an axis of equal size is left alone,
    as ``jax.image.resize`` skips it). CUDA tensors launch the kernel
    ``contract`` once a contraction, unless ``use_kernels=False``."""
    if img.dtype != torch.float32 or img.ndim != 2:
        raise ValueError(f"resize_bilinear takes an f32 [H, W] image, got {img.dtype} {tuple(img.shape)}")
    (h, w), (oh, ow) = img.shape, shape
    out = img.contiguous()
    dev = str(img.device)

    def rows(t):  # out [oh, q] = W_r^T t over the rows
        Wt, lo, hi = _band(h, oh, dev)
        return contract(Wt, t, resize_rows_plan(h, t.shape[1], oh), lo, hi, use_kernels=use_kernels)

    def cols(t):  # out [p, ow] = t W_c, as (W_c^T t^T)^T: the band is W_c's
        Wt, lo, hi = _band(w, ow, dev)
        return contract(Wt, t.T, resize_cols_plan(w), lo, hi, out_t=True, use_kernels=use_kernels)

    steps = ([rows] if oh != h else []) + ([cols] if ow != w else [])
    if len(steps) == 2 and h * w * ow + h * ow * oh < h * w * oh + oh * w * ow:
        steps.reverse()  # the einsum's cheaper path: the columns first (an enlarge)
    for step in steps:
        out = step(out)
    return out
