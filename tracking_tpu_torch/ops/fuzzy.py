"""Fuzzy utilities of the fuzzy-integral algorithms, counterpart of
``tracking_tpu/ops/fuzzy.py`` (tb/FuzzyUtils.cpp, tb/PixelUtils.cpp):

- :func:`fuzzy_lbp`: ``FuzzyUtils::LBP``: interior pixels get the 8
  neighbour ``>=``-centre bits weighted 1..128 over 255; of the border
  only pixel (0, 0) is computed (the reference's other border branches
  never run), the rest stay 0;
- :func:`similarity_ratio`: ``RatioPixels``, min / max with equal -> 1;
- :func:`color_convert_f32`: ``PixelUtils::ColorConversion`` (1 RGB copy,
  2 Ohta on BGR order, 3 HSV, 4 YCrCb, OpenCV's float formulas);
- :func:`sugeno_integral` / :func:`choquet_integral` over three criteria,
  sorted by the reference's compare-exchange network, with its quirk: the
  sorted array is indexed by the original positions.

Float order as XLA:CPU runs the JAX code: a division by a constant is the
product by its f32 reciprocal (``recip``), divisions by tensors divide.
"""

from __future__ import annotations

import torch

from tracking_tpu_torch.ops.consensus import recip

# interior neighbour order of getNeighberhoodGrayPixel: (drow, dcol, weight)
_NEIGHBORS = [
    (-1, 1, 1.0), (0, 1, 2.0), (1, 1, 4.0), (-1, 0, 8.0),
    (1, 0, 16.0), (-1, -1, 32.0), (0, -1, 64.0), (1, -1, 128.0),
]
_R255 = recip(255.0)


def fuzzy_lbp(gray_f: torch.Tensor) -> torch.Tensor:
    """[H, W] f32 grey -> [H, W] f32 LBP in [0, 1]; borders 0 but (0, 0)."""
    h, w = gray_f.shape
    acc = torch.zeros_like(gray_f)
    for dr, dc, wt in _NEIGHBORS:
        nb = torch.roll(gray_f, shifts=(-dr, -dc), dims=(0, 1))
        acc = acc + (nb >= gray_f).to(torch.float32) * wt
    out = torch.zeros_like(gray_f)
    out[1 : h - 1, 1 : w - 1] = acc[1 : h - 1, 1 : w - 1] * _R255
    g = gray_f
    c = ((g[1, 0] >= g[0, 0]).to(torch.float32) * 2.0 + (g[0, 1] >= g[0, 0]).to(torch.float32) * 4.0
         + (g[1, 1] >= g[0, 0]).to(torch.float32) * 8.0)
    out[0, 0] = c * _R255
    return out


def similarity_ratio(cur: torch.Tensor, bg: torch.Tensor) -> torch.Tensor:
    """Elementwise RatioPixels: cur < bg -> cur / bg; cur > bg -> bg / cur;
    equal -> 1."""
    one = torch.ones((), dtype=torch.float32, device=cur.device)
    return torch.where(cur == bg, one, torch.where(cur < bg, cur / bg, bg / cur))


def color_convert_f32(bgr_f: torch.Tensor, color_space: int) -> torch.Tensor:
    """[H, W, 3] f32 BGR in [0, 1] -> the converted 3-channel image."""
    b, g, r = bgr_f[..., 0], bgr_f[..., 1], bgr_f[..., 2]
    if color_space == 1:
        return bgr_f
    if color_space == 2:  # Ohta on the raw channel order
        i1 = (b + g + r) * recip(3.0)
        i2 = (b - r) * 0.5
        i3 = (g * 2.0 - b - r) * 0.25
        return torch.stack([i1, i2, i3], dim=-1)
    dev = bgr_f.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if color_space == 3:  # OpenCV BGR2HSV float: H in [0, 360), S, V in [0, 1]
        v = torch.maximum(torch.maximum(b, g), r)
        mn = torch.minimum(torch.minimum(b, g), r)
        diff = v - mn
        s = torch.where(v > 0, diff / torch.clamp(v, min=1e-20), zero)
        safe = torch.clamp(diff, min=1e-20)
        hr = torch.where(v == r, (g - b) * 60.0 / safe, zero)
        hg = torch.where((v == g) & (v != r), (b - r) * 60.0 / safe + 120.0, zero)
        hb = torch.where((v == b) & (v != r) & (v != g), (r - g) * 60.0 / safe + 240.0, zero)
        hh = torch.where(diff == 0, zero, hr + hg + hb)
        hh = torch.where(hh < 0, hh + 360.0, hh)
        return torch.stack([hh, s, v], dim=-1)
    if color_space == 4:  # OpenCV BGR2YCrCb float, delta 0.5
        y = r * 0.299 + g * 0.587 + b * 0.114
        cr = (r - y) * 0.713 + 0.5
        cb = (b - y) * 0.564 + 0.5
        return torch.stack([y, cr, cb], dim=-1)
    raise ValueError(f"unknown color space {color_space}")


def _integral_terms(hi: torch.Tensor, g: tuple):
    """The three criteria sorted descending by a stable compare-exchange
    network (swap on strict <) carrying the original indices; returns
    (HI_sorted[Indice[k]], g[Indice[k]]) for k = 0, 1, 2: the sorted array
    indexed by original positions, as the reference does."""
    v = [hi[..., 0], hi[..., 1], hi[..., 2]]
    ix = [torch.full(v[0].shape, k, dtype=torch.int32, device=hi.device) for k in range(3)]
    for i, j in ((0, 1), (1, 2), (0, 1)):
        swap = v[i] < v[j]
        v[i], v[j] = torch.where(swap, v[j], v[i]), torch.where(swap, v[i], v[j])
        ix[i], ix[j] = torch.where(swap, ix[j], ix[i]), torch.where(swap, ix[i], ix[j])
    gc = [torch.full((), x, dtype=torch.float32, device=hi.device) for x in g]

    def sel(idx, vals):
        return torch.where(idx == 0, vals[0], torch.where(idx == 1, vals[1], vals[2]))

    return [sel(ix[k], v) for k in range(3)], [sel(ix[k], gc) for k in range(3)]


def sugeno_integral(hi: torch.Tensor, g: tuple) -> torch.Tensor:
    """[..., 3] criteria -> [...] Sugeno integral (the final max folds in 0)."""
    hperm, g_idx = _integral_terms(hi, g)
    xixj = g_idx[1] + g_idx[2]
    i0 = torch.clamp(hperm[0], max=1.0)
    i1 = torch.minimum(hperm[1], xixj)
    i2 = torch.minimum(hperm[2], g_idx[2])
    return torch.clamp(torch.maximum(torch.maximum(i0, i1), i2), min=0.0)


def choquet_integral(hi: torch.Tensor, g: tuple) -> torch.Tensor:
    """[..., 3] criteria -> [...] Choquet integral."""
    hperm, g_idx = _integral_terms(hi, g)
    xixj = g_idx[1] + g_idx[2]
    return hperm[0] * (1.0 - xixj) + hperm[1] * (xixj - g_idx[2]) + hperm[2] * g_idx[2]
