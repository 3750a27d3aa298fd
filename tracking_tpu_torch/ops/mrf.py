"""MRF label relaxation with time constraints (tb/MRF.cpp, ``MRF_TC``),
counterpart of ``tracking_tpu/ops/mrf.py``: per pixel and label L in {0,
1} the energy is the local evidence (squared Mahalanobis distance of the
grey pixel to the dominant mode's grey mean, the FG hypothesis shifted by
2.5 sigma toward the pixel), plus +-beta (2.8) per 8-neighbour of the
current labelling agreeing / disagreeing, plus +-beta_time (0.9) per
8-neighbour and the centre of the previous labelling. ``ICM2``'s two
raster Gauss-Seidel sweeps are red / black checkerboard half-sweeps, as in
the JAX package. Neighbour counts are small integers (exact in any order);
the evidence divides by device tensors and takes correctly rounded roots
(``xla_math.sqrt``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tracking_tpu_torch.ops import xla_math

BETA = 2.8  # MRF.cpp:28
BETA_TIME = 0.9  # MRF.cpp:55


def _neighbor_sum8(x: torch.Tensor) -> torch.Tensor:
    """Sum of the 8 neighbours, zero outside the image."""
    H, W = x.shape
    p = F.pad(x, (1, 1, 1, 1))
    out = torch.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = out + p[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
    return out


def icm_relax(mask_u8, gray, mu0_gray, var0, old_labeling_u8, *, sweeps: int = 2, enabled=True) -> torch.Tensor:
    """ICM relaxation of a 0/255 mask; returns the smoothed 0/255 mask
    where ``enabled`` (a bool or a 0-d tensor), else ``mask_u8``. gray /
    mu0_gray / var0: per-pixel grey value, dominant-mode grey mean and
    variance (``InitEvidence2``)."""
    one = torch.ones((), dtype=torch.float32, device=gray.device)
    var0 = torch.where(var0 == 0, one, var0)
    d_bg = gray - mu0_gray
    ev0 = d_bg * d_bg / (var0 * 2.0)
    shift = xla_math.sqrt(var0) * 2.5
    d_fg = torch.where(gray >= mu0_gray, d_bg - shift, d_bg + shift)
    ev1 = d_fg * d_fg / (var0 * 2.0)

    old1 = (old_labeling_u8 > 0).to(torch.float32)
    n_old1 = _neighbor_sum8(old1) + old1
    cnt = _neighbor_sum8(torch.ones_like(gray))
    n_tot = cnt + 1.0
    time0 = (n_old1 * 2.0 - n_tot) * BETA_TIME
    time1 = (n_tot - n_old1 * 2.0) * BETA_TIME

    cls = (mask_u8 > 0).to(torch.float32)
    H, W = mask_u8.shape
    yy = torch.arange(H, device=gray.device)[:, None]
    xx = torch.arange(W, device=gray.device)[None, :]
    red = (yy + xx) % 2 == 0

    def half_sweep(cls, color):
        d1 = (cnt - _neighbor_sum8(cls) * 2.0) * BETA
        e0 = ev0 + -d1 + time0
        e1 = ev1 + d1 + time1
        return torch.where(color, torch.where(e0 < e1, 0.0, 1.0), cls)

    for _ in range(sweeps):
        cls = half_sweep(cls, red)
        cls = half_sweep(cls, ~red)
    out = (cls * 255.0).to(torch.uint8)
    return torch.where(torch.as_tensor(enabled, device=mask_u8.device), out, mask_u8)
