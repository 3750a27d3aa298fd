"""Canny edge detector, counterpart of ``tracking_tpu/ops/canny.py`` (cv::Canny
with the L1 gradient; MultiCue's ghost-region test).

3×3 Sobel over a replicated border, the magnitude |gx| + |gy|, non-maximum
suppression in four sectors (the f32 products ``t22 · |gx|`` and
``t67 · |gx|`` decide the sector), then hysteresis. The JAX package grows
the strong pixels through the weak ones by 8-connected dilations until
nothing changes; that fixed point is every 8-connected component of the
weak pixels that holds a strong pixel (strong ⊆ weak, as high > low). The
port labels the weak pixels with :func:`tracking_tpu_torch.ops.cc.
label_components` (the CUDA union-find kernel on the card) and keeps the
components whose label a strong pixel carries. :func:`hysteresis_ref` is
the dilation fixed point, the plain version the tests hold it to.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tracking_tpu_torch.ops.cc import label_components, label_components_ref
from tracking_tpu_torch.ops.lbsp import edge_pad

T22 = 0.4142135623730951
T67 = 2.414213562373095


def _sobel(g: torch.Tensor):
    p = edge_pad(g, 1, 1, 1, 1)
    h, w = g.shape

    def sl(dy, dx):
        return p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    gx = (sl(-1, 1) + 2 * sl(0, 1) + sl(1, 1)) - (sl(-1, -1) + 2 * sl(0, -1) + sl(1, -1))
    gy = (sl(1, -1) + 2 * sl(1, 0) + sl(1, 1)) - (sl(-1, -1) + 2 * sl(-1, 0) + sl(-1, 1))
    return gx, gy


def _peaks(gray_u8: torch.Tensor, low: float, high: float):
    """(strong, weak) bool maps after the non-maximum suppression."""
    g = gray_u8.to(torch.float32)
    gx, gy = _sobel(g)
    ax, ay = gx.abs(), gy.abs()
    mag = ax + ay
    diag = (gx * gy) >= 0
    sector_h = ay <= T22 * ax
    sector_v = ay >= T67 * ax
    h, w = mag.shape
    p = F.pad(mag, (1, 1, 1, 1))

    def shift(dy, dx):
        return p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    n_h = torch.maximum(shift(0, 1), shift(0, -1))
    n_v = torch.maximum(shift(1, 0), shift(-1, 0))
    n_d1 = torch.maximum(shift(1, 1), shift(-1, -1))
    n_d2 = torch.maximum(shift(1, -1), shift(-1, 1))
    nmax = torch.where(sector_h, n_h, torch.where(sector_v, n_v, torch.where(diag, n_d1, n_d2)))
    peak = mag >= nmax
    return peak & (mag > high), peak & (mag > low)


def hysteresis_ref(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """The JAX package's loop: 8-connected dilations of ``strong`` inside
    ``weak`` until nothing changes."""
    reach = strong & weak
    h, w = reach.shape
    while True:
        p = F.pad(reach.to(torch.uint8), (1, 1, 1, 1))
        grown = torch.zeros_like(reach)
        for dy in range(3):
            for dx in range(3):
                grown = grown | (p[dy : dy + h, dx : dx + w] > 0)
        grown = grown & weak
        if torch.equal(grown, reach):
            return reach
        reach = grown


def hysteresis(strong: torch.Tensor, weak: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
    """Weak pixels 8-connected through weak pixels to a strong one: the
    components of ``weak`` (``label_components``, 8-connected) that hold
    a strong pixel. ``use_kernels=False`` labels with the plain version
    on the card too."""
    h, w = weak.shape
    n = h * w
    lab = (label_components if use_kernels else label_components_ref)(weak, 8)
    idx = torch.where(lab >= 0, lab, n).reshape(-1).long()
    flag = torch.zeros(n + 1, dtype=torch.int32, device=weak.device)
    flag.index_add_(0, idx, (strong & weak).reshape(-1).to(torch.int32))
    flag[n] = 0
    return flag[idx].reshape(h, w) > 0


def canny(gray_u8: torch.Tensor, low: float = 100.0, high: float = 150.0, use_kernels: bool = True) -> torch.Tensor:
    """u8 [H, W] -> 0/255 u8 edge map."""
    strong, weak = _peaks(gray_u8, low, high)
    return torch.where(hysteresis(strong, weak, use_kernels), 255, 0).to(torch.uint8)
