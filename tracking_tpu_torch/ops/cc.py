"""Connected-component labelling and blob statistics, counterpart of
``tracking_tpu/ops/cc.py``.

A label is the row-major index of the component's minimum pixel; background
is −1. :func:`label_components` launches the CUDA union-find kernel
(``csrc/cc.cu``, replacing ``ops/pallas_cc.py:label_components_pallas``) on
CUDA tensors; :func:`label_components_ref` is its plain version: min-label
propagation with pointer jumping until nothing changes.

:func:`extract_blobs` is the reference's scatter form (``cc.py:305-334``):
per-label integer moments by scatter-add / scatter-min / scatter-max (order
does not matter for integers), then the ``max_blobs`` largest components.
``jax.lax.top_k`` puts the lower index first among equal areas; a stable
sort on −area does the same (``torch.topk`` promises no order for ties).

For the row-sharded path (``parallel/spatial.py``): :func:`label_fixpoint`
launches the CUDA kernel that replaces ``ops/pallas_cc.py:
label_fixpoint_pallas`` (min of arbitrary initial labels over each
component) beside its plain version :func:`label_fixpoint_ref`; and
:func:`blob_row_moments` / :func:`blob_finalize` build the blob table from
exact int32 per-row and per-column counts that shards can sum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tracking_tpu_torch.ops import _native


class Blobs(NamedTuple):
    """Fixed-capacity blob table (invalid slots have area == 0)."""

    area: torch.Tensor  # [K] int32
    cx: torch.Tensor  # [K] f32 centroid x
    cy: torch.Tensor  # [K] f32 centroid y
    x0: torch.Tensor  # [K] int32 bbox
    y0: torch.Tensor  # [K] int32
    x1: torch.Tensor  # [K] int32 (inclusive)
    y1: torch.Tensor  # [K] int32 (inclusive)
    label: torch.Tensor  # [K] int32 root label (pixel index), -1 if invalid

    @property
    def w(self):
        return torch.clamp(self.x1 - self.x0 + 1, min=0)

    @property
    def h(self):
        return torch.clamp(self.y1 - self.y0 + 1, min=0)


def _neighbor_min(lab: torch.Tensor, fg: torch.Tensor, conn8: bool, big: int) -> torch.Tensor:
    H, W = lab.shape
    p = F.pad(lab, (1, 1, 1, 1), value=big)
    out = lab
    for dy in range(3):
        for dx in range(3):
            if (dy == 1 and dx == 1) or (not conn8 and dy != 1 and dx != 1):
                continue
            out = torch.minimum(out, p[dy : dy + H, dx : dx + W])
    return torch.where(fg, out, big)


def label_components_ref(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """Plain torch labelling: exact component-minimum labels."""
    H, W = mask.shape
    big = H * W
    fg = mask > 0
    iota = torch.arange(big, dtype=torch.int32, device=mask.device).reshape(H, W)
    lab = torch.where(fg, iota, big)
    ext = torch.full((1,), big, dtype=torch.int32, device=mask.device)
    while True:
        new = _neighbor_min(lab, fg, connectivity == 8, big)
        for _ in range(2):  # pointer jumping: label <- label of its label
            flat = torch.cat([new.reshape(-1), ext])
            new = torch.where(fg, torch.minimum(new, flat[new.reshape(-1).long()].reshape(H, W)), big)
        if torch.equal(new, lab):
            break
        lab = new
    return torch.where(fg, lab, -1)


def label_components(mask: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """mask [H, W] (u8 or bool) -> int32 labels. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if mask.device.type == "cpu":
        return label_components_ref(mask, connectivity)
    H, W = mask.shape
    # the kernel reads any nonzero byte as foreground: u8 and bool masks go
    # in as they are, with no conversion launched
    fg = (mask if mask.dtype in (torch.uint8, torch.bool) else mask > 0).contiguous()
    _native.require(fg, "mask", fg.dtype, (H, W))
    out = torch.empty((H, W), dtype=torch.int32, device=mask.device)
    rc = _native.library().tt_label_components(
        fg.data_ptr(), out.data_ptr(), H, W, connectivity, _native.stream_ptr()
    )
    _native.check(rc, "label_components")
    _native.count_launch("label_components")
    return out


def _run_min(lab: torch.Tensor, fg: torch.Tensor, big: int) -> torch.Tensor:
    """Per row: the minimum label over each maximal foreground run, on the
    run's pixels; ``big`` on background (one whole-line propagation step)."""
    H, W = lab.shape
    seg = torch.cumsum((~fg).to(torch.int32), dim=1)  # run id within the row
    key = (torch.arange(H, device=lab.device, dtype=torch.int32)[:, None] * (W + 1) + seg).reshape(-1).long()
    acc = torch.full((H * (W + 1),), big, dtype=torch.int32, device=lab.device)
    acc.scatter_reduce_(0, key, torch.where(fg, lab, big).reshape(-1), reduce="amin", include_self=True)
    return torch.where(fg, acc[key].reshape(H, W), big)


def label_fixpoint_ref(fg: torch.Tensor, lab0: torch.Tensor, big: int, connectivity: int = 8):
    """Plain torch: row and column run minima and one neighbour minimum,
    repeated until nothing changes. ``fg`` bool [H, W]; ``lab0`` int32
    [H, W], ``big`` on background. Returns (labels, converged): the
    minimum of ``lab0`` over each component, ``big`` on background, and
    True (there is no round cap)."""
    lab = torch.where(fg, lab0, big)
    while True:
        new = torch.minimum(lab, _run_min(lab, fg, big))
        new = torch.minimum(new, _run_min(new.t(), fg.t(), big).t())
        new = _neighbor_min(new, fg, connectivity == 8, big)
        if torch.equal(new, lab):
            return lab, True
        lab = new


def label_fixpoint(fg: torch.Tensor, lab0: torch.Tensor, big: int, connectivity: int = 8,
                   use_kernels: bool = True):
    """Same contract as :func:`label_fixpoint_ref`. CPU tensors take the
    plain version; CUDA tensors launch the kernel unless ``use_kernels=False``.
    The JAX package's ``base`` argument steers only its pointer jumping and
    has no counterpart here."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if fg.device.type == "cpu" or not use_kernels:
        return label_fixpoint_ref(fg, lab0, big, connectivity)
    H, W = fg.shape
    _native.require(fg, "fg", torch.bool, (H, W))
    _native.require(lab0, "lab0", torch.int32, (H, W))
    parent = torch.empty((H, W), dtype=torch.int32, device=fg.device)
    out = torch.empty((H, W), dtype=torch.int32, device=fg.device)
    rc = _native.library().tt_label_fixpoint(
        fg.data_ptr(), lab0.data_ptr(), parent.data_ptr(), out.data_ptr(), H, W, connectivity, big,
        _native.stream_ptr(),
    )
    _native.check(rc, "label_fixpoint")
    _native.count_launch("label_fixpoint")
    return out, True


def blob_row_moments(cnt_rk: torch.Tensor, ys: torch.Tensor, H: int):
    """Row-axis blob moments from an int32 per-row count matrix [rows, K]
    whose rows are the global rows ``ys`` (``cc.py:blob_row_moments``):
    area, Σy, and the bbox rows as maxima ((H−1)−min y and max y, −1 where
    empty), all exact int32, so shards' partials combine by sum and max."""
    cnt = cnt_rk.to(torch.int32)
    pr = cnt > 0
    ys = ys.to(torch.int32)[:, None]
    area = cnt.sum(dim=0, dtype=torch.int32)
    sy = (cnt * ys).sum(dim=0, dtype=torch.int32)
    ny0 = torch.where(pr, (H - 1) - ys, -1).amax(dim=0).to(torch.int32)
    y1 = torch.where(pr, ys, -1).amax(dim=0).to(torch.int32)
    return area, sy, ny0, y1


def blob_finalize(rows, cnt_wk: torch.Tensor, roots: torch.Tensor, H: int, W: int) -> Blobs:
    """Blob table from combined row moments and full column counts [W, K]
    (``cc.py:blob_finalize``)."""
    area, sy, ny0, y1 = rows
    dev = area.device
    xs = torch.arange(W, dtype=torch.int32, device=dev)[:, None]
    cnt_w = cnt_wk.to(torch.int32)
    pw = cnt_w > 0
    sx = (cnt_w * xs).sum(dim=0, dtype=torch.int32)
    x0 = (W - 1) - torch.where(pw, (W - 1) - xs, -1).amax(dim=0)
    x1 = torch.where(pw, xs, -1).amax(dim=0)
    ok = area > 0
    inv_a = torch.reciprocal(torch.clamp(area.to(torch.float32), min=1.0))
    zf = torch.zeros((), dtype=torch.float32, device=dev)
    return Blobs(
        area=torch.where(ok, area, 0).to(torch.int32),
        cx=torch.where(ok, sx.to(torch.float32) * inv_a, zf),
        cy=torch.where(ok, sy.to(torch.float32) * inv_a, zf),
        x0=torch.where(ok, x0, 0).to(torch.int32),
        y0=torch.where(ok, (H - 1) - ny0, 0).to(torch.int32),
        x1=torch.where(ok, x1, -1).to(torch.int32),
        y1=torch.where(ok, y1, -1).to(torch.int32),
        label=torch.where(ok, roots, -1).to(torch.int32),
    )


def _areas(mask: torch.Tensor, max_blobs: int, connectivity: int, use_kernels: bool):
    """(flat labels, valid, own-bin index, the ``max_blobs`` bins of largest
    area, lower label first among ties, and their areas): the labelling and
    component areas shared by :func:`extract_blobs` and :func:`area_gate`.
    A background pixel scatters
    its neutral value into its own bin, which no component uses (labels are
    foreground pixels): the same tables as the reference's single overflow
    bin, without 90 % of a frame's pixels contending for one atomic address
    on the card."""
    n = mask.numel()
    label_fn = label_components if use_kernels else label_components_ref
    flat = label_fn(mask, connectivity).reshape(-1)
    valid = flat >= 0
    idx = torch.where(valid, flat, torch.arange(n, dtype=torch.int32, device=mask.device)).long()
    area = torch.zeros(n + 1, dtype=torch.int32, device=mask.device).index_add_(0, idx, valid.to(torch.int32))
    order = torch.sort(-area, stable=True).indices[:max_blobs]
    return flat, valid, idx, order, area[order]


def extract_blobs(
    mask: torch.Tensor, max_blobs: int = 64, connectivity: int = 8, use_kernels: bool = True
) -> Blobs:
    """Binary mask [H, W] -> the ``max_blobs`` largest components by area.
    ``use_kernels=False`` takes the plain labelling even on the card."""
    H, W = mask.shape
    n = H * W
    dev = mask.device
    _, valid, idx, order, top_area = _areas(mask, max_blobs, connectivity, use_kernels)
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    ys, xs = pix // W, pix % W

    def scat(init, src, neutral, reduce):
        out = torch.full((n + 1,), init, dtype=torch.int32, device=dev)
        src = torch.where(valid, src, neutral)
        if reduce == "sum":
            return out.index_add_(0, idx, src)
        return out.scatter_reduce_(0, idx, src, reduce=reduce, include_self=True)

    sx = scat(0, xs, 0, "sum")
    sy = scat(0, ys, 0, "sum")
    bx0 = scat(W, xs, W, "amin")
    by0 = scat(H, ys, H, "amin")
    bx1 = scat(-1, xs, -1, "amax")
    by1 = scat(-1, ys, -1, "amax")

    ok = top_area > 0
    inv_a = torch.reciprocal(torch.clamp(top_area.to(torch.float32), min=1.0))
    zf = torch.zeros((), dtype=torch.float32, device=dev)
    return Blobs(
        area=torch.where(ok, top_area, 0),
        cx=torch.where(ok, sx[order].to(torch.float32) * inv_a, zf),
        cy=torch.where(ok, sy[order].to(torch.float32) * inv_a, zf),
        x0=torch.where(ok, bx0[order], 0),
        y0=torch.where(ok, by0[order], 0),
        x1=torch.where(ok, bx1[order], -1),
        y1=torch.where(ok, by1[order], -1),
        label=torch.where(ok, order.to(torch.int32), -1),
    )


def area_gate(
    mask: torch.Tensor, min_area: float, max_blobs: int = 64, connectivity: int = 8, use_kernels: bool = True
) -> torch.Tensor:
    """Zero out components smaller than ``min_area`` (FGD's minArea gate):
    keep the ``max_blobs`` largest components (lower label first among equal
    areas) whose area is at least ``min_area``; u8 0/255 out. The semantics
    of the reference's CPU branch (``cc.py:381-393``); its TPU branch's
    128-root-candidate shortcut is not ported."""
    H, W = mask.shape
    n = H * W
    flat, valid, _, order, top_area = _areas(mask, max_blobs, connectivity, use_kernels)
    flag = torch.zeros(n + 1, dtype=torch.bool, device=mask.device)
    flag.scatter_(0, torch.where(top_area > 0, order, n), top_area >= min_area)
    flag[n] = False
    keep = flag[torch.where(valid, flat, n).long()].reshape(H, W)
    return torch.where(keep, 255, 0).to(torch.uint8)
