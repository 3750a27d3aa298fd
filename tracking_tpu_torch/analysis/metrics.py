"""Mask-quality metrics, counterpart of ``tracking_tpu/analysis/metrics.py``:
the IoU-style similarity of ``ForegroundMaskAnalysis.cpp:57-69``, the
confusion counts, ROC table and sweep of ``tb/PerformanceUtils.cpp:57-457``
and FET's recall / precision / F-score (``fet/fet.py:30-103``).

Masks are u8 0/255 (or bool) tensors with any leading batch dims, on any
device. Counts are f32, as the reference's: a count over fewer than 2^24
pixels is exact in any order; a longer one rounds, and :func:`count_f32`
adds in XLA:CPU's order so that it rounds as the reference's does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tracking_tpu_torch.ops.color import fold
from tracking_tpu_torch.ops.consensus import recip

_F32 = torch.float32
_EXACT = 1 << 24  # f32 holds every whole number up to here
_WINDOW = 32  # XLA:CPU's tree reduction: windows of 32 along each reduced dim


def _as_bool(m: torch.Tensor) -> torch.Tensor:
    return m if m.dtype == torch.bool else m > 0


def _c(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=_F32, device=like.device)


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """f32 sum of non-negative whole numbers over the last axis, term by
    term in index order: at once where no partial sum passes 2^24 (then
    every order is exact), else one f32 addition at a time."""
    exact = x.to(torch.float64).sum(-1)
    if x.shape[-1] == 0 or float(exact.max()) <= _EXACT:
        return exact.to(_F32)
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def count_f32(mask: torch.Tensor, dims=None) -> torch.Tensor:
    """The f32 count of the true entries of ``mask`` over ``dims`` (all by
    default), as XLA:CPU's ``jnp.sum(mask, dtype=float32)`` adds: while a
    reduced dim is longer than 32, sum windows of 32 along each reduced dim
    (a dim of at most 32 whole), zero-padded on both sides to a multiple of
    32 (the lower side the smaller half), each window in row-major order;
    then the rest in row-major order (read from the optimized HLO)."""
    m = _as_bool(mask)
    dims = sorted(d % m.ndim for d in (range(m.ndim) if dims is None else dims))
    if math.prod(m.shape[d] for d in dims) <= _EXACT:
        return m.sum(dim=dims, dtype=torch.int64).to(_F32)
    x = m.to(_F32)
    while any(x.shape[d] > _WINDOW for d in dims):
        pads, shape = [], []
        for d, n in enumerate(x.shape):
            w = 1 if d not in dims else min(n, _WINDOW)
            pad = -(-n // w) * w - n
            pads.append((pad // 2, pad - pad // 2))
            shape += [-(-n // w), w]
        x = torch.nn.functional.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        nd = len(pads)
        x = x.reshape(shape).permute([2 * d for d in range(nd)] + [2 * d + 1 for d in range(nd)])
        x = _sum_last(x.reshape(x.shape[:nd] + (-1,)))
    keep = [d for d in range(x.ndim) if d not in dims]
    x = x.permute(keep + dims)
    return _sum_last(x.reshape(x.shape[: len(keep)] + (-1,)))


def mask_similarity(pred: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """IoU: |pred ∧ ref| / |pred ∨ ref| (1.0 when both are empty)."""
    a, b = _as_bool(pred), _as_bool(ref)
    inter, union = count_f32(a & b), count_f32(a | b)
    return torch.where(union == 0, 1.0, inter / torch.clamp(union, min=1.0))


def confusion_counts(pred: torch.Tensor, ref: torch.Tensor):
    """(TP, FP, TN, FN) pixel counts (fet.py's definitions: ref is the
    ground truth, 255 positive)."""
    p, g = _as_bool(pred), _as_bool(ref)
    return count_f32(p & g), count_f32(p & ~g), count_f32(~p & ~g), count_f32(~p & g)


def precision_recall_fscore(pred: torch.Tensor, ref: torch.Tensor):
    """(precision, recall, F1), a zero denominator giving 0 (fet.py:93-103)."""
    tp, fp, _, fn = confusion_counts(pred, ref)
    precision = torch.where(tp + fp == 0, 0.0, tp / torch.clamp(tp + fp, min=1.0))
    recall = torch.where(tp + fn == 0, 0.0, tp / torch.clamp(tp + fn, min=1.0))
    denom = precision + recall
    f1 = torch.where(denom == 0, 0.0, 2.0 * precision * recall / torch.maximum(denom, _c(1e-12, denom)))
    return precision, recall, f1


def image_roc(pred: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Coded confusion image (``PerformanceUtils::ImageROC``'s display path,
    ``tb/PerformanceUtils.cpp:298-341``): TP 30, TN 0, FP 255, FN 100 (u8)."""
    p, g = _as_bool(pred), _as_bool(ref)
    code = torch.where(p & g, 30, torch.where(p & ~g, 255, torch.where(~p & g, 100, 0)))
    return code.to(torch.uint8)


def roc_threshold_search(score_img, ref):
    """Per-intensity TP/TN/FP/FN table of ``PerformanceUtils::ImageROC``'s
    saveResults branch (``tb/PerformanceUtils.cpp:345-457``), numpy as the
    JAX package's: ``freq[i][c]`` is the running class-c count at the last
    raster position of a class-c pixel of intensity i (the reference's
    ordering quirk). Returns [256, 7] f64: TP, TN, FP, FN, FNR, FPR, DR;
    rows with a zero denominator keep zero rates."""
    img = np.asarray(score_img, dtype=np.uint8).reshape(-1)
    g = np.asarray(ref).reshape(-1) != 0
    p = img != 0
    cls = np.where(p & g, 0, np.where(~p & ~g, 1, np.where(p & ~g, 2, 3)))
    freq = np.zeros((256, 7), np.float64)
    for c in range(4):
        pos = np.nonzero(cls == c)[0]
        if pos.size == 0:
            continue
        cum = np.arange(1, pos.size + 1, dtype=np.float64)
        u, first_rev = np.unique(img[pos][::-1], return_index=True)
        freq[u, c] = cum[::-1][first_rev]
    tp, tn, fp, fn = freq[:, 0], freq[:, 1], freq[:, 2], freq[:, 3]
    ok = ((fn + tp) != 0) & ((fp + tn) != 0)
    with np.errstate(invalid="ignore", divide="ignore"):
        freq[ok, 4] = fn[ok] / (fn[ok] + tp[ok])  # FNR
        freq[ok, 5] = fp[ok] / (fp[ok] + tn[ok])  # FPR
        freq[ok, 6] = tp[ok] / (tp[ok] + fn[ok])  # DR
    return freq


def save_roc_file(score_img, ref, filename: str) -> None:
    """Write the reference's ROC threshold-search table
    (``tb/PerformanceUtils.cpp:407-447``): a header and one ``%3d %6.0f ×4
    %1.6f ×3`` line per intensity with non-zero denominators, columns I TP
    TN FP FN FPR FNR DR. Tensors on any device are accepted."""
    as_np = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else a  # noqa: E731
    freq = roc_threshold_search(as_np(score_img), as_np(ref))
    with open(filename, "w") as f:
        f.write("  I     TP     TN     FP     FN    FPR      FNR      DR   \n\n")
        for i in range(256):
            tp, tn, fp, fn = freq[i, :4]
            if (fn + tp != 0.0) and (fp + tn != 0.0):
                f.write("%3d %6.0f %6.0f %6.0f %6.0f %1.6f %1.6f %1.6f\n"
                        % (i, tp, tn, fp, fn, freq[i, 5], freq[i, 4], freq[i, 6]))


def _linspace_0_255(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 255, n)`` (f32) as JAX computes it: a jitted
    constant that XLA folds to i · f32(f32(1/(n − 1)) · 255) for i < n − 1
    (the division by n − 1 rewritten as the reciprocal's product, the
    constants multiplied first), then 255; torch's ``linspace`` steps
    otherwise. Checked equal for n = 2..399."""
    if n == 1:
        return torch.zeros(1, dtype=_F32, device=device)
    out = torch.arange(n - 1, dtype=_F32, device=device) * fold(recip(n - 1), 255.0)
    return torch.cat([out, torch.full((1,), 255.0, dtype=_F32, device=device)])


def roc_curve(score_img: torch.Tensor, ref: torch.Tensor, num_thresholds: int = 256):
    """TPR / FPR over u8 thresholds (``PerformanceUtils::ImageROC``'s
    analogue): score_img u8 [H, W], ref a binary mask. Returns (thresholds
    [N], tpr [N], fpr [N])."""
    g = _as_bool(ref)
    thresholds = _linspace_0_255(num_thresholds, score_img.device)
    pred = score_img[None] > thresholds[:, None, None]
    tp = count_f32(pred & g[None], (1, 2))
    fp = count_f32(pred & ~g[None], (1, 2))
    pos, neg = count_f32(g), count_f32(~g)
    return thresholds, tp / torch.clamp(pos, min=1.0), fp / torch.clamp(neg, min=1.0)
