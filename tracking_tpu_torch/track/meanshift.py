"""Mean-shift refinement, counterpart of ``tracking_tpu/track/meanshift.py``.

- ``meanshift_refine`` / ``meanshift_refine_batch`` (and, for the
  row-sharded path, ``meanshift_refine_batch_sharded``): the CCMSPF
  collision resolver over the FG mask;
- ``backproject``, ``color_histogram``, ``particle_refine``: the reference's
  whole-frame helpers;
- ``window_color_hist``, ``meanshift_color_refine`` and
  ``particle_color_refine``: the MS / MSFG / MSPF trackers' birth template
  and per-track refinement over a colour back-projection, for all K tracks
  at once (the reference vmaps them over the tracks).

Each of ``iters`` iterations moves a WIN×WIN window (start clamped into the
image, as ``dynamic_slice`` clamps) to its weighted centroid. All K windows
move together as one [K, WIN, WIN] gather: no per-track host round trip.
With a binary weight, the window sums are integers below 2**24, exact in f32
in any summation order. The colour weights are not integers, so there the
order of every float sum is XLA:CPU's (:func:`sequential_sum`): a window's
1,024 terms and a histogram bin's scatter-adds one after another in index
order, a 512-bin normalisation in runs of 32 (``ops/gmg.py:blocked_sum``).
"""

from __future__ import annotations

import numpy as np
import torch

from tracking_tpu_torch.ops import rng

WIN = 32
BINS = 8  # per channel: 8 x 8 x 8 colour bins


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


# -- the MS family's colour windows ------------------------------------------


def sequential_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ of ``x`` over ``dim``, term after term in index order, in f32 - the
    order of XLA:CPU's reductions over at most 32 x 32 elements and of its
    scatter-adds. On the card a cumulative sum over a leading axis runs
    one thread per output along the axis, in order (torch's outer-dim scan),
    so its last entry is that sum; on the CPU torch accumulates a cumsum in
    f64, so numpy's f32 accumulate (sequential) takes its place there.
    (A scan over a tensor whose other axes are all 1 takes torch's
    parallel scan, so a lone column gets a zero column beside it.)"""
    x = x.movedim(dim, 0)
    if x.device.type == "cpu":
        acc = np.add.accumulate(x.contiguous().numpy(), axis=0, dtype=np.float32)
        return torch.from_numpy(np.array(acc[-1], copy=True))  # 0-d stays 0-d
    rest = x.shape[1:]
    cols = x.reshape(x.shape[0], -1)
    if cols.shape[1] == 1:  # a lone column would take the parallel whole-tensor scan
        cols = torch.cat([cols, torch.zeros_like(cols)], dim=1)
    return torch.cumsum(cols, dim=0)[-1][: rest.numel()].reshape(rest)


def blocked_sum(x: torch.Tensor, block: int = 32) -> torch.Tensor:
    """Σ over the last axis in XLA:CPU's order for a reduction over more
    than 32 elements: runs of ``block`` in index order, then the runs' sums
    in order (the axis' length is a multiple of ``block``)."""
    runs = sequential_sum(x.reshape(x.shape[:-1] + (-1, block)), -1)
    return sequential_sum(runs, -1)


def _scatter_add_seq(code: torch.Tensor, wt: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``zeros([K, n_bins]).at[k, code[k]].add(wt[k])`` with each bin's terms
    added in index order (XLA:CPU's scatter). code int64 / wt f32 [K, N]."""
    K, N = code.shape
    if code.device.type == "cpu":
        flat = (torch.arange(K, device=code.device)[:, None] * n_bins + code).reshape(-1)
        out = torch.zeros(K * n_bins, dtype=torch.float32, device=code.device)
        return out.index_add_(0, flat, wt.reshape(-1)).reshape(K, n_bins)  # in index order on the CPU
    # on the card index_add_ adds with atomics in no fixed order: each bin
    # sums its own terms (others contribute +0.0) along the N axis in order
    bins = torch.arange(n_bins, device=code.device)
    terms = torch.where(code[:, :, None] == bins, wt[:, :, None], torch.zeros((), device=code.device))
    return sequential_sum(terms, 1)


def _codes(pix: torch.Tensor) -> torch.Tensor:
    """u8 [..., 3] -> int64 bin code (q0 * 8 + q1) * 8 + q2, q = v >> 5."""
    q = pix.to(torch.int64) >> (8 - 3)
    return (q[..., 0] * BINS + q[..., 1]) * BINS + q[..., 2]


def _color_windows(frame_u8: torch.Tensor, fg_f: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor):
    """The [..., WIN, WIN] windows at centres (cy, cx) [...]: bin codes,
    FG weights and the windows' origins (clamped as ``dynamic_slice``)."""
    h, w = fg_f.shape
    i = torch.arange(WIN, device=fg_f.device)
    y0 = torch.clamp(cy.to(torch.int32) - WIN // 2, 0, h - WIN)
    x0 = torch.clamp(cx.to(torch.int32) - WIN // 2, 0, w - WIN)
    rows = (y0[..., None] + i)[..., :, None].long()
    cols = (x0[..., None] + i)[..., None, :].long()
    return _codes(frame_u8[rows, cols]), fg_f[rows, cols], y0, x0


def backproject(frame_u8: torch.Tensor, hist: torch.Tensor, bins: int = BINS) -> torch.Tensor:
    """[H, W, 3] u8 + [bins³] template -> [H, W] f32 weight image. The
    reference adds one bin's value per pixel to zeros, so the pixel's bin
    value plus 0.0."""
    q = frame_u8.to(torch.int64) >> (8 - 3)
    code = (q[..., 0] * bins + q[..., 1]) * bins + q[..., 2]
    return torch.zeros((), dtype=torch.float32, device=hist.device) + hist[code]


def color_histogram(frame_u8: torch.Tensor, mask: torch.Tensor, bins: int = BINS) -> torch.Tensor:
    """FG-weighted colour histogram (MSFG semantics), [bins³] normalised.
    Its counts are integers, exact in any order."""
    q = frame_u8.to(torch.int64) >> (8 - 3)
    code = (q[..., 0] * bins + q[..., 1]) * bins + q[..., 2]
    wt = (mask > 0).to(torch.float32)
    hist = torch.zeros(bins**3, dtype=torch.float32, device=wt.device).index_add_(0, code.reshape(-1), wt.reshape(-1))
    return hist / torch.maximum(blocked_sum(hist), torch.full((), 1e-6, device=wt.device))


def particle_refine(weight: torch.Tensor, key: torch.Tensor, cy, cx, n_particles: int = 16, sigma: float = 6.0,
                    iters: int = 3):
    """MSPF over a binary weight: jitter ``n_particles`` centres by JAX's
    normals, keep the heaviest window (the first on ties), mean-shift it."""
    ks = rng.split(key)
    cys = cy + rng.normal(ks[0], (n_particles,)) * sigma
    cxs = cx + rng.normal(ks[1], (n_particles,)) * sigma
    win, _, _ = _windows(weight, cys, cxs)
    best = torch.argmax(win.sum(dim=(1, 2)))
    return meanshift_refine(weight, cys[best], cxs[best], iters)


def window_color_hist(frame_u8: torch.Tensor, fg_f: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
                      bins: int = BINS) -> torch.Tensor:
    """FG-weighted colour histograms [K, bins³] of the WIN×WIN windows at
    (cy, cx) [K], normalised: the MS trackers' templates at birth. Each
    weight carries a 1e-3 floor so an empty-FG window still has a
    template."""
    code, fwin, _, _ = _color_windows(frame_u8, fg_f, cy, cx)
    K = cy.shape[0]
    wt = fwin + 1e-3
    hist = _scatter_add_seq(code.reshape(K, -1), wt.reshape(K, -1), bins**3)
    return hist / torch.maximum(blocked_sum(hist), torch.full((), 1e-6, device=hist.device))[:, None]


def _color_weights(frame_u8, fg_f, hist, cy, cx, use_fg: bool):
    """Back-projected weights [..., WIN, WIN] of the windows at (cy, cx)
    [...] (``hist`` [..., bins³]) and the windows' origins."""
    code, fwin, y0, x0 = _color_windows(frame_u8, fg_f, cy, cx)
    lead = code.shape[:-2]
    wt = torch.gather(hist, -1, code.reshape(lead + (-1,))).reshape(code.shape)
    if use_fg:
        wt = wt * fwin
    return wt, y0, x0


def meanshift_color_refine(frame_u8: torch.Tensor, fg_f: torch.Tensor, hist: torch.Tensor, cy: torch.Tensor,
                           cx: torch.Tensor, use_fg: bool, iters: int = 5):
    """Mean-shift of K windows over each track's colour back-projection
    (``hist`` [K, bins³]), computed only inside the window; ``use_fg``
    multiplies the FG mask in (MSFG). Returns (cy, cx, mass), each [K]."""
    dev = fg_f.device
    ys = torch.arange(WIN, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(WIN, dtype=torch.float32, device=dev)[None, :]
    eps = torch.full((), 1e-6, dtype=torch.float32, device=dev)
    for _ in range(iters):
        wt, y0, x0 = _color_weights(frame_u8, fg_f, hist, cy, cx, use_fg)
        lead = wt.shape[:-2]
        m, sy, sx = sequential_sum(torch.stack([wt, wt * ys, wt * xs]).reshape((3,) + lead + (-1,)), -1)
        ok = m > eps
        cy = torch.where(ok, y0.to(torch.float32) + sy / torch.maximum(m, eps), cy)
        cx = torch.where(ok, x0.to(torch.float32) + sx / torch.maximum(m, eps), cx)
    wt, _, _ = _color_weights(frame_u8, fg_f, hist, cy, cx, use_fg)
    return cy, cx, sequential_sum(wt.reshape(wt.shape[:-2] + (-1,)), -1)


def particle_color_refine(frame_u8: torch.Tensor, fg_f: torch.Tensor, hist: torch.Tensor, keys: torch.Tensor,
                          cy: torch.Tensor, cx: torch.Tensor, use_fg: bool, n_particles: int = 16,
                          sigma: float = 6.0, iters: int = 3):
    """MSPF for K tracks (``keys`` [K, 2]): each jitters ``n_particles``
    centres by JAX's normals, keeps the heaviest back-projection window (the
    first on ties) and refines it by :func:`meanshift_color_refine`."""
    ks = rng.split(keys)  # [K, 2, 2]
    cys = cy[:, None] + rng.normal(ks[:, 0], (n_particles,)) * sigma
    cxs = cx[:, None] + rng.normal(ks[:, 1], (n_particles,)) * sigma
    hp = hist[:, None, :].expand(-1, n_particles, -1)
    wt, _, _ = _color_weights(frame_u8, fg_f, hp, cys, cxs, use_fg)
    masses = sequential_sum(wt.reshape(wt.shape[:2] + (-1,)), -1)
    best = torch.argmax(masses, dim=1, keepdim=True)
    return meanshift_color_refine(frame_u8, fg_f, hist, cys.gather(1, best)[:, 0], cxs.gather(1, best)[:, 0], use_fg,
                                  iters)
