"""Mean-shift refinement over a weight image, counterpart of
``tracking_tpu/track/meanshift.py`` (``meanshift_refine`` /
``meanshift_refine_batch``; the MS-family trackers are not ported yet).

Each of ``iters`` iterations moves a WIN×WIN window (start clamped into the
image, as ``dynamic_slice`` clamps) to its weighted centroid. All K windows
move together as one [K, WIN, WIN] gather: no per-track host round trip.
With a binary weight, the window sums are integers below 2**24, exact in f32
in any summation order.
"""

from __future__ import annotations

import torch

WIN = 32


def _windows(weight: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor):
    h, w = weight.shape
    y0 = torch.clamp(cy.to(torch.int32) - WIN // 2, 0, h - WIN)
    x0 = torch.clamp(cx.to(torch.int32) - WIN // 2, 0, w - WIN)
    i = torch.arange(WIN, device=weight.device)
    rows = (y0[:, None] + i)[:, :, None]
    cols = (x0[:, None] + i)[:, None, :]
    return weight[rows.long(), cols.long()], y0, x0


def meanshift_refine_batch(weight: torch.Tensor, cys: torch.Tensor, cxs: torch.Tensor, iters: int = 5):
    """Refine a [K] batch of centres over ``weight`` [H, W] f32. Returns
    (cy, cx, mass), each [K] f32."""
    ys = torch.arange(WIN, dtype=torch.float32, device=weight.device)[:, None]
    xs = torch.arange(WIN, dtype=torch.float32, device=weight.device)[None, :]
    eps = torch.full((), 1e-6, dtype=torch.float32, device=weight.device)
    cy, cx = cys, cxs
    for _ in range(iters):
        win, y0, x0 = _windows(weight, cy, cx)
        m = win.sum(dim=(1, 2))
        my = (win * ys).sum(dim=(1, 2)) / torch.maximum(m, eps)
        mx = (win * xs).sum(dim=(1, 2)) / torch.maximum(m, eps)
        ok = m > 0
        cy = torch.where(ok, y0.to(torch.float32) + my, cy)
        cx = torch.where(ok, x0.to(torch.float32) + mx, cx)
    win, _, _ = _windows(weight, cy, cx)
    return cy, cx, win.sum(dim=(1, 2))


def meanshift_refine(weight: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor, iters: int = 5):
    """One centre (0-d tensors). Returns (cy, cx, mass)."""
    y, x, m = meanshift_refine_batch(weight, cy.reshape(1), cx.reshape(1), iters)
    return y[0], x[0], m[0]
