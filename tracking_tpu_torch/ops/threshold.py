"""Thresholding as ``cv::threshold(..., THRESH_BINARY)``, counterpart of
``tracking_tpu/ops/threshold.py``: strictly greater."""

from __future__ import annotations

import torch


def threshold_binary(img: torch.Tensor, thresh, maxval: int = 255) -> torch.Tensor:
    """u8: ``maxval`` where ``img > thresh``, else 0. ``thresh`` is a scalar
    or a per-pixel tensor."""
    return torch.where(img > thresh, maxval, 0).to(torch.uint8)
