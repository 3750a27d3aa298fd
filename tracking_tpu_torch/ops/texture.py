"""DPTexture's windowed LBP histograms and their intersection with the
model: the CUDA kernel ``texture_prox_cur`` (``csrc/texture.cu``, replacing
``tracking_tpu/ops/pallas_texture.py:texture_prox_cur_pallas``) and its
plain version ``texture_prox_cur_ref`` (the XLA branch of
``tracking_tpu/bgs/texture.py``: ``_region_hist`` and the proximity sum).

Per channel, the 64-bin histogram of the 6-bit LBP codes in the 11×11
window around each pixel (positions outside the image count nothing; the
codes' zeroed 2-px border counts in bin 0), and the histogram intersection
``prox = Σ_{channel, bin} min(model, cur)``. All integer, so exact.
"""

from __future__ import annotations

import torch

from tracking_tpu_torch.ops import _native

REGION_R = 5
NUM_BINS = 64


def region_hist(code: torch.Tensor) -> torch.Tensor:
    """[H, W] u8 code -> [64, H, W] u8 counts over the 11×11 window
    (``texture._region_hist``): a zero-padded one-hot, box-summed rows then
    columns. Counts stay ≤ 121, so u8 holds them."""
    H, W = code.shape
    k = 2 * REGION_R + 1
    bins = torch.arange(NUM_BINS, dtype=torch.uint8, device=code.device)[:, None, None]
    onehot = (code[None] == bins).to(torch.uint8)
    padded = torch.nn.functional.pad(onehot, (REGION_R, REGION_R, REGION_R, REGION_R))
    rows = padded[:, 0:H, :]
    for d in range(1, k):
        rows = rows + padded[:, d : d + H, :]
    cnt = rows[:, :, 0:W]
    for d in range(1, k):
        cnt = cnt + rows[:, :, d : d + W]
    return cnt


def texture_prox_cur_ref(codes: torch.Tensor, model: torch.Tensor):
    """Plain torch. codes [3, H, W] u8 (LBP codes, 2-px border zeroed);
    model [3, 64, H, W] u8. Returns (prox int32 [H, W], cur [3, 64, H, W] u8)."""
    cur = torch.stack([region_hist(codes[c]) for c in range(codes.shape[0])])
    prox = torch.minimum(model, cur).sum(dim=(0, 1), dtype=torch.int32)
    return prox, cur


def texture_prox_cur(codes: torch.Tensor, model: torch.Tensor):
    """Same contract as :func:`texture_prox_cur_ref`. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if codes.device.type == "cpu":
        return texture_prox_cur_ref(codes, model)
    C, H, W = codes.shape
    _native.require(codes, "codes", torch.uint8, (C, H, W))
    _native.require(model, "model", torch.uint8, (C, NUM_BINS, H, W))
    prox = torch.empty((H, W), dtype=torch.int32, device=codes.device)
    cur = torch.empty_like(model)
    rc = _native.library().tt_texture_prox_cur(
        codes.data_ptr(), model.data_ptr(), prox.data_ptr(), cur.data_ptr(), C, H, W, _native.stream_ptr()
    )
    _native.check(rc, "texture_prox_cur")
    _native.count_launch("texture_prox_cur")
    return prox, cur
