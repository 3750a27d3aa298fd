"""Histogram equalisation as ``cv::equalizeHist``, counterpart of
``tracking_tpu/ops/hist.py`` (the PreProcessor's ``equalizeHist``,
``PreProcessor.cpp:65-66``): the 256-bin histogram, its first non-zero bin
i0, scale = 255 / (N − hist[i0]), lut[i] = round((cumsum[i] − cumsum[i0]) ·
scale), applied as a table lookup."""

from __future__ import annotations

import torch


def equalize_hist(img: torch.Tensor) -> torch.Tensor:
    """Equalise a u8 image [..., H, W], each image over its last two dims."""
    lead = img.shape[:-2]
    flat = img.reshape(-1, img.shape[-2] * img.shape[-1]).to(torch.int64)
    B, n = flat.shape
    hist = torch.zeros((B, 256), dtype=torch.int32, device=img.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    cum = torch.cumsum(hist, dim=-1, dtype=torch.int32)
    i0 = torch.argmax((hist > 0).to(torch.int32), dim=-1, keepdim=True)  # the first non-zero bin
    h0 = hist.gather(1, i0)
    denom = torch.clamp(n - h0, min=1)
    # a constant over a tensor: a true f32 division (Python ``255.0 / t``
    # would be a reciprocal product in torch)
    scale = torch.full((), 255.0, dtype=torch.float32, device=img.device) / denom.to(torch.float32)
    lut_f = (cum - cum.gather(1, i0)).to(torch.float32) * scale
    lut = torch.clamp(torch.round(lut_f), 0, 255).to(torch.uint8)
    return lut.gather(1, flat).reshape(lead + img.shape[-2:])
