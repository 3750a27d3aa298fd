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
Its two contractions are XLA ``dot``s, which XLA:CPU
hands to Eigen's contraction: an output is a sum over k in blocks, each
block one FMA chain from +0 in index order, the blocks' sums added to the
output in order (:func:`_contract_ref`). The blocks, measured at 24 x 32
outputs: over the rows (k = H), H split in ceil(H / 320) equal slices
rounded up to 8 (720 -> 3 x 240, 1080 -> 4 x 272; one block up to 320);
over the columns (k = W), blocks of 1,024. Only a weight's band of
nonzero terms is visited: a zero term leaves a chain unchanged (the image
is finite). Where XLA:CPU splits k over its threads instead (an H of 240
to 576 with a W of 320 to 720: blocks of 96, added in a tree) the port
differs from it in the last bits.

On CUDA tensors each contraction is the kernel ``resize_bilinear``
(``csrc/resize.cu``, a thread an output in the same order); CPU tensors take
the plain version.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tracking_tpu_torch.ops import _native, xla_math

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


_ROW_SLICE = 320  # Eigen's largest depth block over the rows, before its equal slices
_COL_BLOCK = 1024


def _row_block(k: int) -> int:
    slices = -(-k // _ROW_SLICE)
    return min(k, -(-(k // slices) // 8) * 8)


@lru_cache(maxsize=None)
def _band(m: int, n: int, device: str):
    """weight_mat(m, n) on ``device`` with each output's first and last
    input of nonzero weight (int32 [n]; hi < lo where there is none)."""
    w = weight_mat(m, n)
    nz = w != 0
    any_ = nz.any(0)
    lo = np.where(any_, nz.argmax(0), 0).astype(np.int32)
    hi = np.where(any_, m - 1 - nz[::-1].argmax(0), -1).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device) for v in (w, lo, hi))


def _contract_ref(W, X, lo, hi, kc: int) -> torch.Tensor:
    """out[i, j] = Σ_k W[k, i] X[k, j] over k in [lo[i], hi[i]]: one FMA
    chain from +0 a block of ``kc`` inputs, the block sums added in order."""
    P = W.shape[1]
    cols = torch.arange(P, device=W.device)
    out = torch.zeros((P, X.shape[1]), dtype=torch.float32, device=W.device)
    acc = torch.zeros_like(out)
    blk = lo.long() // kc
    for b in range(int((hi - lo).max().clamp(min=-1)) + 1):
        k = (lo + b).long()
        live = k <= hi
        k = torch.minimum(k, hi.long()).clamp(min=0)
        new = live & (k // kc != blk)
        out = torch.where(new[:, None], out + acc, out)
        acc = torch.where(new[:, None], 0.0, acc)
        blk = torch.where(new, k // kc, blk)
        acc = torch.where(live[:, None], xla_math.fma(W[k, cols][:, None], X[k], acc), acc)
    return out + acc


def _contract(W, X, lo, hi, kc: int, transpose: bool, use_kernels: bool) -> torch.Tensor:
    """``_contract_ref(W, X)`` (or of ``X.T`` with the result transposed,
    ``transpose``); on the card the kernel reads X and writes the result
    through strides."""
    if W.device.type == "cpu" or not use_kernels:
        out = _contract_ref(W, X.T if transpose else X, lo, hi, kc)
        return out.T.contiguous() if transpose else out
    _native.require(X, "img", torch.float32)
    P = W.shape[1]
    Q = X.shape[0] if transpose else X.shape[1]
    out = torch.empty((Q, P) if transpose else (P, Q), dtype=torch.float32, device=X.device)
    sxk, sxq = (1, X.shape[1]) if transpose else (X.shape[1], 1)
    sop, soq = (1, P) if transpose else (Q, 1)
    rc = _native.library().tt_resize_contract(W.data_ptr(), X.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                                              out.data_ptr(), P, Q, kc, P, sxk, sxq, sop, soq, _native.stream_ptr())
    _native.check(rc, "resize_bilinear")
    _native.count_launch("resize_bilinear")
    return out


def resize_bilinear(img: torch.Tensor, shape, use_kernels: bool = True) -> torch.Tensor:
    """f32 [H, W] -> f32 ``shape`` (an axis of equal size is left alone,
    as ``jax.image.resize`` skips it). CUDA tensors launch the kernel
    ``resize_bilinear`` once a contraction, unless ``use_kernels=False``."""
    if img.dtype != torch.float32 or img.ndim != 2:
        raise ValueError(f"resize_bilinear takes an f32 [H, W] image, got {img.dtype} {tuple(img.shape)}")
    (h, w), (oh, ow) = img.shape, shape
    out = img.contiguous()
    dev = str(img.device)

    def rows(t):
        W, lo, hi = _band(h, oh, dev)
        return _contract(W, t, lo, hi, _row_block(h), False, use_kernels)

    def cols(t):
        W, lo, hi = _band(w, ow, dev)
        return _contract(W, t, lo, hi, _COL_BLOCK, True, use_kernels)

    steps = ([rows] if oh != h else []) + ([cols] if ow != w else [])
    if len(steps) == 2 and h * w * ow + h * ow * oh < h * w * oh + oh * w * ow:
        steps.reverse()  # the einsum's cheaper path: the columns first (an enlarge)
    for step in steps:
        out = step(out)
    return out
