"""Blob property / filter layer (the jmo CBlob / CBlobResult library),
counterpart of ``tracking_tpu/ops/blobs.py``.

Per-blob properties (area, crack perimeter and its image-border part, raw
moments, image mean / stddev, bounding box, Cauchy hull perimeter), the
evaluator family (``CBlobGetArea`` … ``CBlobGetAxisRatio``,
``package_bgs/jmo/blob.h:81-830``), the moment ellipse, and
``CBlobResult::Filter`` / ``GetNumBlobs`` / ``GetNthBlob`` / ``FillBlob``
(``BlobResult.h:109-180``) over a fixed-capacity :class:`BlobTable` whose
fields, dtypes and estimators are the JAX package's (its module docstring
lists where they depart from the reference's contour code).

:func:`blob_properties` labels the mask with :func:`.cc.label_components`
(the CUDA union-find kernel on the card, its plain version on the CPU), then
computes every statistic from the labels without the JAX package's
``[H, W, K]`` one-hot: integer counts come from scatter-adds (exact in any
order), maxima and minima from scatter-max / min. Its float sums are the
one-hot's contractions, which XLA:CPU runs as matrix-vector products in a
fixed order (``--xla_disable_hlo_passes=fusion``, read from the optimized
HLO and its LLVM IR):

- a row-major product ``M [m, k] · v [k]`` keeps 8 lanes per row; lane l
  adds ``M[r, i] · v[i]`` for i ≡ l (mod 8) in index order with an FMA,
  the last ``k mod 8`` columns go to a scalar accumulator the same way,
  and the lanes are added as ((l0+l1)+(l2+l3))+((l4+l5)+(l6+l7)) for rows
  in whole tiles of 8, ((l0+l4)+(l2+l6))+((l1+l5)+(l3+l7)) for the rest,
  then the scalar (:func:`_lane_sum`);
- a column-major product ``v [h] · M [h, k]`` adds ``v[i] · M[i, k]`` for
  each output in index order with an FMA.

The port writes these orders out: each FMA is one f32 rounding of an exact
sum, here an f32 accumulator plus an exact term held in f64
(``torch.add`` into an f32 output), and a term of the one-hot that is zero
leaves its accumulator unchanged, so only a blob's own pixels are visited.
A lane whose terms are integers with |sum| < 2**24 is exact in any order;
the others run as one sequential column each (:func:`_pixel_sums`).
``blob_properties`` reads a few sizes on the host (the number of pixels
in the table's blobs, the longest lane, the rows holding blobs) to shape
its work.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tracking_tpu_torch.ops import xla_math
from tracking_tpu_torch.ops.cc import label_components, label_components_ref
from tracking_tpu_torch.ops.color import fold
from tracking_tpu_torch.ops.consensus import recip
from tracking_tpu_torch.track.meanshift import sequential_sum

# CBlobResult filter constants (BlobResult.h:76-88), the reference's values
B_INCLUDE = 1
B_EXCLUDE = 2
B_EQUAL = 3
B_NOT_EQUAL = 4
B_GREATER = 5
B_LESS = 6
B_GREATER_OR_EQUAL = 7
B_LESS_OR_EQUAL = 8
B_INSIDE = 9
B_OUTSIDE = 10

_F32 = torch.float32
_F64 = torch.float64
_EXACT = 1 << 24  # integers below this are exact f32 sums in any order
_BIG = float(np.float32(3.4e38))  # the JAX package's masked-max fill


class BlobTable(NamedTuple):
    """Fixed-capacity per-blob property table (CBlobResult analog), the JAX
    package's fields and dtypes. Invalid slots have ``valid`` False and
    zeroed statistics (``maxx`` / ``maxy`` −1, ``label`` −1). All fields
    are ``[K]``; x is the column, y the row."""

    valid: torch.Tensor  # [K] bool
    label: torch.Tensor  # [K] int32 root label (pixel index), -1 if invalid
    area: torch.Tensor  # [K] f32 (moment 00)
    perimeter: torch.Tensor  # [K] f32 crack length incl. image-border sides
    extern_perimeter: torch.Tensor  # [K] f32 crack length on the image border
    sumx: torch.Tensor  # [K] f32 moment 10
    sumy: torch.Tensor  # [K] f32 moment 01
    sumxx: torch.Tensor  # [K] f32 moment 20
    sumyy: torch.Tensor  # [K] f32 moment 02
    sumxy: torch.Tensor  # [K] f32 moment 11
    mean: torch.Tensor  # [K] f32 image mean over the blob (0 without image)
    stddev: torch.Tensor  # [K] f32 image stddev over the blob
    minx: torch.Tensor  # [K] f32 bbox (inclusive)
    maxx: torch.Tensor  # [K] f32
    miny: torch.Tensor  # [K] f32
    maxy: torch.Tensor  # [K] f32
    hull_perimeter: torch.Tensor  # [K] f32 Cauchy-formula convex perimeter


def _c(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=_F32, device=like.device)


def _lane_sum(lanes: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """A row-major product's result from its lanes [..., K, 8] and scalar
    accumulators [..., K] (f32): the lanes added in XLA's tree, the rows of
    the last partial tile of 8 in the other tree, then the scalar."""
    l = lanes.unbind(-1)
    whole = ((l[0] + l[1]) + (l[2] + l[3])) + ((l[4] + l[5]) + (l[6] + l[7]))
    part = ((l[0] + l[4]) + (l[2] + l[6])) + ((l[1] + l[5]) + (l[3] + l[7]))
    K = lanes.shape[-2]
    in_tile = torch.arange(K, device=lanes.device) < K - K % 8
    return torch.where(in_tile, whole, part) + tail


def _rows_product(terms: torch.Tensor) -> torch.Tensor:
    """XLA's row-major matrix-vector product given its exact terms
    ``M[r, i] · v[i]`` as f64 [..., K, L]: each lane and the scalar
    accumulator take one FMA (an f32 rounding of the exact sum) per term."""
    L = terms.shape[-1]
    L8 = L - L % 8
    lanes = torch.zeros(terms.shape[:-1] + (8,), dtype=_F32, device=terms.device)
    for i in range(0, L8, 8):
        torch.add(lanes, terms[..., i : i + 8], out=lanes)
    tail = torch.zeros(terms.shape[:-1], dtype=_F32, device=terms.device)
    for i in range(L8, L):
        torch.add(tail, terms[..., i], out=tail)
    return _lane_sum(lanes, tail)


def _pixel_sums(terms: torch.Tensor, pix: torch.Tensor, slot: torch.Tensor, K: int, n: int,
                integral: torch.Tensor) -> torch.Tensor:
    """XLA's row-major products of the one-hot [K, n] with F pixel vectors,
    from the blobs' own pixels: ``pix`` (ascending pixel indices, int64),
    ``slot`` (their table rows) and ``terms`` (the vectors' f32 values
    there, [F, N]) -> [F, K]. Where ``integral[f]`` (every term of vector f
    an integer) a lane whose |terms| sum below 2**24 is its exact integer
    sum; every other lane is added term by term in pixel order, each as one
    column of a sequential scan."""
    dev = terms.device
    F = terms.shape[0]
    n8 = n - n % 8
    main = pix < n8
    seg = (torch.arange(F, device=dev)[:, None] * K + slot) * 8 + pix % 8  # [F, N]: (vector, slot, lane)
    t64 = terms.to(torch.int64)
    tot = torch.zeros(F * K * 8, dtype=torch.int64, device=dev).index_add_(0, seg[:, main].flatten(),
                                                                           t64[:, main].flatten())
    mag = torch.zeros(F * K * 8, dtype=torch.int64, device=dev).index_add_(0, seg[:, main].flatten(),
                                                                           t64[:, main].abs().flatten())
    exact = (mag < _EXACT) & integral.repeat_interleave(K * 8)
    lanes = torch.where(exact, tot.to(_F32), 0.0)
    seq = main & ~exact[seg]
    s_seg, s_terms = seg[seq], terms[seq]  # vector-major, pixel order within
    if s_seg.numel():
        # one column per lane, its terms in pixel order down the column
        order = torch.sort(s_seg, stable=True).indices
        s_seg, s_terms = s_seg[order], s_terms[order]
        count = torch.zeros(F * K * 8, dtype=torch.int64, device=dev).index_add_(0, s_seg, torch.ones_like(s_seg))
        start = torch.cumsum(count, 0) - count
        col = torch.cumsum((count > 0).to(torch.int64), 0) - 1
        rows, cols = count.max().item(), int(col[-1].item()) + 1
        grid = torch.zeros((rows, cols), dtype=_F32, device=dev)
        grid[torch.arange(s_seg.numel(), device=dev) - start[s_seg], col[s_seg]] = s_terms
        lanes[count > 0] = sequential_sum(grid, 0)
    tail = torch.zeros((F, K), dtype=_F32, device=dev)
    for p in range(n8, n):
        at = pix == p
        term = torch.where(at, terms, 0.0).sum(-1, keepdim=True)  # one term or none
        k = torch.where(at, slot, K).min()
        tail = tail + torch.where(torch.arange(K, device=dev) == k, term, 0.0)
    return _lane_sum(lanes.reshape(F, K, 8), tail)


def _cracks(fg: torch.Tensor):
    """int32 [H, W] crack counts of each foreground pixel: its 4-neighbours
    inside the image that are background, and its sides on the border."""
    H, W = fg.shape
    bg = torch.nn.functional.pad(~fg, (1, 1, 1, 1), value=False)
    inb = torch.nn.functional.pad(torch.ones_like(fg), (1, 1, 1, 1), value=False)
    c_in = torch.zeros((H, W), dtype=torch.int32, device=fg.device)
    c_ext = torch.zeros_like(c_in)
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        nb_bg = bg[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
        nb_in = inb[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
        c_in += nb_bg & nb_in
        c_ext += ~nb_in
    return torch.where(fg, c_in, 0), torch.where(fg, c_ext, 0)


def blob_properties(
    mask: torch.Tensor,
    image: torch.Tensor | None = None,
    max_blobs: int = 64,
    connectivity: int = 8,
    n_cand: int = 128,
    hull_dirs: int = 16,
    use_kernels: bool = True,
) -> BlobTable:
    """Binary mask [H, W] -> :class:`BlobTable` of the ``max_blobs`` largest
    blobs, on the mask's device.

    As in the JAX package, the candidates are the ``n_cand`` components
    whose root (minimum pixel) comes first in row-major order; the table
    holds the largest of those, the lower root first among equal areas. A
    frame with more than ``n_cand`` components ignores the later ones.
    ``image`` (grayscale [H, W], u8 or f32) feeds the mean / stddev.
    ``use_kernels=False`` takes the plain labelling even on the card."""
    H, W = mask.shape
    n = H * W
    K = max_blobs
    if not K <= n_cand <= n:
        raise ValueError(f"need max_blobs <= n_cand <= H*W, got {K}, {n_cand}, {n}")
    dev = mask.device
    fg = mask if mask.dtype == torch.bool else mask > 0
    label_fn = label_components if use_kernels else label_components_ref
    lab = label_fn(mask, connectivity).reshape(-1)

    # the n_cand top-left-most roots (n pads), then the K largest of them
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    score = torch.where(lab == iota, n - iota, 0)
    top = torch.topk(score, n_cand, sorted=True).values
    roots_c = torch.where(top > 0, n - top, n).long()
    on = lab >= 0
    area_lab = torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(on, lab, iota).long(), on.to(torch.int32))
    order = torch.sort(-area_lab[roots_c], stable=True).indices[:K]
    roots = roots_c[order]
    table = torch.full((n + 1,), K, dtype=torch.int64, device=dev)
    table[roots] = torch.arange(K, device=dev)
    table[n] = K
    slot = table[torch.where(on, lab, n).long()]

    # the table's pixels, in pixel order
    pix = torch.nonzero(slot < K).flatten()
    sl = slot[pix]
    py, px = pix // W, pix % W

    def per_slot(key, size, values):
        out = torch.zeros(size * K, dtype=values.dtype, device=dev)
        return out.index_add_(0, key, values).reshape(size, K)

    row_key = py * K + sl
    one = torch.ones_like(pix, dtype=torch.int32)
    cnt_rk = per_slot(row_key, H, one)
    cnt_wk = per_slot(px * K + sl, W, one)
    area = cnt_rk.sum(0, dtype=torch.int32).to(_F32)
    xsum_rk = per_slot(row_key, H, px.to(torch.int32))  # Σx per row, < 2**24

    ys = torch.arange(H, dtype=_F32, device=dev)
    xs = torch.arange(W, dtype=_F32, device=dev)
    cr, cw = cnt_rk.t().to(_F64), cnt_wk.t().to(_F64)
    sy, syy = _rows_product(torch.stack([cr * ys.double(), cr * (ys * ys).double()]))
    sx, sxx = _rows_product(torch.stack([cw * xs.double(), cw * (xs * xs).double()]))
    sxy = torch.zeros(K, dtype=_F32, device=dev)
    xy = xsum_rk.to(_F64) * ys.double()[:, None]
    for h in torch.nonzero(cnt_rk.any(1)).flatten().tolist():
        torch.add(sxy, xy[h], out=sxy)

    # the crack counts and the image's Σ and Σ² (an integer image's terms
    # are integers)
    terms = [c.reshape(-1)[pix].to(_F32) for c in _cracks(fg)]
    integral = [True, True]
    if image is not None:
        img = image.reshape(-1)[pix].to(_F32)
        terms += [img, img * img]
        integral += [not image.is_floating_point() or bool(torch.equal(img, img.trunc()))] * 2
    sums = _pixel_sums(torch.stack(terms), pix, sl, K, n, torch.tensor(integral, device=dev))
    per_in, per_ext = sums[0], sums[1]
    s1, s2 = (sums[2], sums[3]) if image is not None else (torch.zeros(K, dtype=_F32, device=dev),) * 2

    pr, pw = cnt_rk > 0, cnt_wk > 0
    miny = torch.where(pr, ys[:, None], float(H)).amin(0)
    maxy = torch.where(pr, ys[:, None], -1.0).amax(0)
    minx = torch.where(pw, xs[:, None], float(W)).amin(0)
    maxx = torch.where(pw, xs[:, None], -1.0).amax(0)

    # Cauchy hull perimeter: (π/J) Σ_j width_j, XLA folding π/J into one
    # constant. The projection x·cos θ + y·sin θ (two f32 products and a
    # sum) is monotone in x on a row, so a blob's extremes lie among its
    # rows' first and last pixels
    step = fold(math.pi, recip(hull_dirs))
    th = torch.from_numpy(np.arange(hull_dirs, dtype=np.float32) * np.float32(step)).to(dev)
    cos, sin = xla_math.cos(th)[:, None, None], xla_math.sin(th)[:, None, None]
    ends = torch.stack([
        torch.full((H * K,), W, dtype=torch.int64, device=dev).scatter_reduce_(0, row_key, px, "amin"),
        torch.full((H * K,), -1, dtype=torch.int64, device=dev).scatter_reduce_(0, row_key, px, "amax"),
    ]).reshape(2, 1, H, K).to(_F32)
    proj = ends * cos + ys[:, None] * sin  # [2, J, H, K]
    hi = torch.where(pr, proj, -_BIG).amax(dim=(0, 2))
    lo = torch.where(pr, proj, _BIG).amin(dim=(0, 2))
    wsum = torch.zeros(K, dtype=_F32, device=dev)
    for j in range(hull_dirs):
        wsum = wsum + torch.clamp(hi[j] - lo[j] + 1.0, min=0.0)
    hull_per = wsum * step

    ok = area > 0
    inv_a = _c(1.0, mask) / torch.clamp(area, min=1.0)
    mean = s1 * inv_a
    var = torch.clamp(s2 * inv_a - mean * mean, min=0.0)
    z = _c(0.0, mask)
    m1 = _c(-1.0, mask)
    return BlobTable(
        valid=ok,
        label=torch.where(ok, roots, -1).to(torch.int32),
        area=torch.where(ok, area, z),
        perimeter=torch.where(ok, per_in + per_ext, z),
        extern_perimeter=torch.where(ok, per_ext, z),
        sumx=torch.where(ok, sx, z),
        sumy=torch.where(ok, sy, z),
        sumxx=torch.where(ok, sxx, z),
        sumyy=torch.where(ok, syy, z),
        sumxy=torch.where(ok, sxy, z),
        mean=torch.where(ok, mean, z),
        stddev=torch.where(ok, xla_math.sqrt(var), z),
        minx=torch.where(ok, minx, z),
        maxx=torch.where(ok, maxx, m1),
        miny=torch.where(ok, miny, z),
        maxy=torch.where(ok, maxy, m1),
        hull_perimeter=torch.where(ok, hull_per, z),
    )


# ---------------------------------------------------------------------------
# Evaluators (COperadorBlob family, blob.h:259-830): each maps a BlobTable to
# a [K] f32 vector, op by op as the JAX package's eager functions compute it
# ---------------------------------------------------------------------------

def get_area(t: BlobTable):
    return t.area


def get_perimeter(t: BlobTable):
    return t.perimeter


def get_extern_perimeter(t: BlobTable):
    return t.extern_perimeter


def get_extern_perimeter_ratio(t: BlobTable):
    """blob.h:629-643: externPerimeter/perimeter (externPerimeter if P=0)."""
    return torch.where(t.perimeter != 0, t.extern_perimeter / torch.clamp(t.perimeter, min=1e-12), t.extern_perimeter)


def get_extern_hull_perimeter_ratio(t: BlobTable):
    return torch.where(t.hull_perimeter != 0, t.extern_perimeter / torch.clamp(t.hull_perimeter, min=1e-12),
                       t.extern_perimeter)


def get_exterior(t: BlobTable):
    """1 if the blob touches the image border (CBlob::Exterior)."""
    return (t.extern_perimeter > 0).to(_F32)


def get_mean(t: BlobTable):
    return t.mean


def get_stddev(t: BlobTable):
    return t.stddev


def get_compactness(t: BlobTable):
    """P²/(4π·A), 0 for empty blobs (blob.cpp:872-878)."""
    return torch.where(t.area != 0, (t.perimeter * t.perimeter) / (4.0 * math.pi * torch.clamp(t.area, min=1e-12)), 0.0)


def _breadth_c(t: BlobTable):
    """The reference's rectangle-model breadth solve (blob.cpp:920-940):
    the blob as a rectangle with P = 2(l+b), A = l·b."""
    tmp = t.perimeter * t.perimeter - 16.0 * t.area
    return torch.where(tmp > 0, (t.perimeter + xla_math.sqrt(torch.clamp(tmp, min=0.0))) / 4.0, t.perimeter / 4.0)


def _length_breadth(t: BlobTable):
    b = _breadth_c(t)
    return t.area / torch.clamp(b, min=1e-12), b


def get_length(t: BlobTable):
    l, b = _length_breadth(t)
    return torch.where(b > 0, torch.maximum(l, b), 0.0)


def get_breadth(t: BlobTable):
    l, b = _length_breadth(t)
    return torch.where(b > 0, torch.minimum(l, b), 0.0)


def get_elongation(t: BlobTable):
    """length/breadth via the same rectangle model (blob.cpp:844-856)."""
    l, b = _length_breadth(t)
    return torch.where(b > 0, torch.maximum(l, b) / torch.clamp(torch.minimum(l, b), min=1e-12), 0.0)


def get_roughness(t: BlobTable):
    """perimeter / hull perimeter (blob.cpp:894-902)."""
    return torch.where(t.hull_perimeter != 0, t.perimeter / torch.clamp(t.hull_perimeter, min=1e-12), 0.0)


def get_hull_perimeter(t: BlobTable):
    return t.hull_perimeter


def get_diff_x(t: BlobTable):
    return t.maxx - t.minx


def get_diff_y(t: BlobTable):
    return t.maxy - t.miny


def get_min_x(t: BlobTable):
    return t.minx


def get_max_x(t: BlobTable):
    return t.maxx


def get_min_y(t: BlobTable):
    return t.miny


def get_max_y(t: BlobTable):
    return t.maxy


def get_x_center(t: BlobTable):
    return t.minx + (t.maxx - t.minx) / 2.0


def get_y_center(t: BlobTable):
    return t.miny + (t.maxy - t.miny) / 2.0


def get_moment(t: BlobTable, p: int = 0, q: int = 0):
    """Raw pq moment for pq in {00, 10, 01, 20, 02, 11} (a superset of the
    reference's, blob.cpp:587-610); other orders return 0."""
    table = {
        (0, 0): t.area, (1, 0): t.sumx, (0, 1): t.sumy,
        (2, 0): t.sumxx, (0, 2): t.sumyy, (1, 1): t.sumxy,
    }
    return table.get((p, q), torch.zeros_like(t.area))


def get_distance_from_point(t: BlobTable, x: float = 0.0, y: float = 0.0):
    dx = get_x_center(t) - x
    dy = get_y_center(t) - y
    return xla_math.sqrt(dx * dx + dy * dy)


def get_xy_inside(t: BlobTable, x: float = 0.0, y: float = 0.0):
    """Bbox-membership test (the reference tests edge-polygon membership)."""
    return ((t.minx <= x) & (t.maxx >= x) & (t.miny <= y) & (t.maxy >= y) & t.valid).to(_F32)


def moment_ellipse(t: BlobTable):
    """(cx, cy, major, minor, angle_rad): the equivalent-inertia ellipse from
    central second moments. Axis lengths are FULL lengths (4√λ), matching
    CvBox2D.size; the angle in radians in [0, π) like CBlobGetOrientation."""
    inv_a = _c(1.0, t.area) / torch.clamp(t.area, min=1.0)
    cx = t.sumx * inv_a
    cy = t.sumy * inv_a
    # + 1/12: discrete pixels carry unit-square self-inertia
    mxx = t.sumxx * inv_a - cx * cx + 1.0 / 12.0
    myy = t.sumyy * inv_a - cy * cy + 1.0 / 12.0
    mxy = t.sumxy * inv_a - cx * cy
    d = mxx - myy
    common = xla_math.sqrt(d * d + 4.0 * mxy * mxy)
    l1 = torch.clamp((mxx + myy + common) / 2.0, min=0.0)
    l2 = torch.clamp((mxx + myy - common) / 2.0, min=0.0)
    angle = torch.remainder(0.5 * xla_math.atan2(2.0 * mxy, d), _c(math.pi, t.area))
    z = torch.zeros_like(cx)
    ok = t.valid & (t.area > 0)
    return (
        torch.where(ok, cx, z), torch.where(ok, cy, z),
        torch.where(ok, 4.0 * xla_math.sqrt(l1), z), torch.where(ok, 4.0 * xla_math.sqrt(l2), z),
        torch.where(ok, angle, z),
    )


def get_major_axis_length(t: BlobTable):
    return moment_ellipse(t)[2]


def get_minor_axis_length(t: BlobTable):
    return moment_ellipse(t)[3]


def get_orientation(t: BlobTable):
    return moment_ellipse(t)[4]


def get_orientation_cos(t: BlobTable):
    return xla_math.cos(get_orientation(t)).abs()


def get_axis_ratio(t: BlobTable):
    _, _, major, minor, _ = moment_ellipse(t)
    return torch.where(major > 0, minor / torch.clamp(major, min=1e-12), 0.0)


def get_area_ellipse_ratio(t: BlobTable):
    """π·(major/2)·(minor/2) / area (blob.h:717-739)."""
    _, _, major, minor, _ = moment_ellipse(t)
    return torch.where(t.area > 0, math.pi * (major / 2.0) * (minor / 2.0) / torch.clamp(t.area, min=1e-12), 0.0)


# ---------------------------------------------------------------------------
# CBlobResult operations
# ---------------------------------------------------------------------------

def _invalidate(t: BlobTable, keep: torch.Tensor) -> BlobTable:
    """Zero out the slots not kept (the fixed-shape analog of CBlobResult's
    element removal)."""
    out = {}
    for name, v in t._asdict().items():
        if name == "valid":
            out[name] = t.valid & keep
        elif name == "label":
            out[name] = torch.where(keep, v, -1).to(v.dtype)
        elif name in ("maxx", "maxy"):
            out[name] = torch.where(keep, v, -1.0)
        else:
            out[name] = torch.where(keep, v, torch.zeros_like(v))
    return BlobTable(**out)


def filter_blobs(
    t: BlobTable,
    values: torch.Tensor,
    condition: int,
    low: float,
    high: float = 0.0,
    action: int = B_INCLUDE,
) -> BlobTable:
    """CBlobResult::Filter (BlobResult.cpp): keep (B_INCLUDE) or drop
    (B_EXCLUDE) the blobs whose evaluator value meets the condition; the
    bounds are compared as f32."""
    v = values
    lo = torch.full((), low, dtype=v.dtype, device=v.device)
    hi = torch.full((), high, dtype=v.dtype, device=v.device)
    if condition == B_EQUAL:
        meets = v == lo
    elif condition == B_NOT_EQUAL:
        meets = v != lo
    elif condition == B_GREATER:
        meets = v > lo
    elif condition == B_LESS:
        meets = v < lo
    elif condition == B_GREATER_OR_EQUAL:
        meets = v >= lo
    elif condition == B_LESS_OR_EQUAL:
        meets = v <= lo
    elif condition == B_INSIDE:
        meets = (v >= lo) & (v <= hi)
    elif condition == B_OUTSIDE:
        meets = (v < lo) | (v > hi)
    else:
        raise ValueError(f"unknown filter condition {condition}")
    keep = meets if action == B_INCLUDE else ~meets
    return _invalidate(t, keep)


def get_num_blobs(t: BlobTable) -> torch.Tensor:
    """CBlobResult::GetNumBlobs: the count of valid slots (int32)."""
    return t.valid.sum(dtype=torch.int32)


def nth_blob(t: BlobTable, values: torch.Tensor, n: int, largest: bool = True) -> BlobTable:
    """CBlobResult::GetNthBlob: the n-th blob (0-based) after a stable sort
    by an evaluator (invalid slots last), as a table of 0-d tensors."""
    fill = -math.inf if largest else math.inf
    v = torch.where(t.valid, values, fill)
    i = torch.argsort(-v if largest else v, stable=True)[n]
    return BlobTable(*(a[i] for a in t))


def paint_blobs(lab: torch.Tensor, t: BlobTable) -> torch.Tensor:
    """bool [H, W]: True where the label image belongs to a valid blob of
    the table (CBlob::FillBlob over the result set); one flag per label
    (a valid slot's label is a pixel index), gathered by label."""
    n = lab.numel()
    at = torch.where(t.valid, t.label.long(), n)
    flag = torch.zeros(n + 1, dtype=torch.int32, device=lab.device).index_add_(0, at, t.valid.to(torch.int32))
    return flag[torch.where(lab >= 0, lab, n).long()] > 0
