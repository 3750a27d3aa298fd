"""Binary median filter, counterpart of ``tracking_tpu/ops/filters.py``."""

from __future__ import annotations

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
