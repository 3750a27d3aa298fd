"""Mean-shift refinement over a weight image, counterpart of
``tracking_tpu/track/meanshift.py`` (``meanshift_refine`` /
``meanshift_refine_batch`` and, for the row-sharded path,
``meanshift_refine_batch_sharded``; the MS-family trackers are not ported
yet).

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


def meanshift_refine_batch_sharded(ctx, weight_own: torch.Tensor, cys: torch.Tensor, cxs: torch.Tensor,
                                   iters: int = 5):
    """Row-sharded :func:`meanshift_refine_batch` (``meanshift.py:70-131``):
    ``weight_own`` is this rank's [h_loc, W] rows of a binary f32 weight and
    ``ctx`` a ``parallel.spatial.SpatialCtx``. Each iteration sums each
    window's mass and first moments over the rank's own rows, then over the
    ranks (one ``psum`` of a [3, K] table). The sums are integers below
    2**24, exact in f32 in any split, so the result equals the unsharded
    refinement bit for bit."""
    h_loc, w = weight_own.shape
    dev = weight_own.device
    i = torch.arange(WIN, device=dev)
    ys = torch.arange(WIN, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(WIN, dtype=torch.float32, device=dev)[None, :]
    eps = torch.full((), 1e-6, dtype=torch.float32, device=dev)

    def moments(cy, cx):
        y0 = torch.clamp(cy.to(torch.int32) - WIN // 2, 0, ctx.H - WIN)
        x0 = torch.clamp(cx.to(torch.int32) - WIN // 2, 0, w - WIN)
        rows = y0[:, None] + i - ctx.row0  # the window's rows in this rank's
        own = (rows >= 0) & (rows < h_loc)
        win = weight_own[rows.clamp(0, h_loc - 1)[:, :, None].long(), (x0[:, None] + i)[:, None, :].long()]
        win = win * own[:, :, None].to(torch.float32)
        part = torch.stack([win.sum(dim=(1, 2)), (win * ys).sum(dim=(1, 2)), (win * xs).sum(dim=(1, 2))])
        return ctx.psum(part), y0, x0

    cy, cx = cys, cxs
    for _ in range(iters):
        (m, sy, sx), y0, x0 = moments(cy, cx)
        ok = m > 0
        cy = torch.where(ok, y0.to(torch.float32) + sy / torch.maximum(m, eps), cy)
        cx = torch.where(ok, x0.to(torch.float32) + sx / torch.maximum(m, eps), cx)
    (m, _, _), _, _ = moments(cy, cx)
    return cy, cx, m
