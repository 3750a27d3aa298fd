"""SuBSENSE sample consensus with deferred bank writes: the CUDA kernel
``consensus`` (``csrc/consensus.cu``, replacing
``tracking_tpu/ops/pallas_consensus.py:consensus_pallas``) and its plain
version ``consensus_ref`` (the reference's XLA branch:
``bgs/lbsp_family.py:_apply_pending_xla`` followed by the sample scan).

Per pixel, in order:
1. replay frame t−1's pending log into the N sample banks: a self write
   and a 3×3/5×5 neighbour spread, decoded from one packed control word
   (:func:`pack_pending_ctrl`) and the packed colour|desc|fire values
   (:func:`pack_pending_vals`); the spread wins over the self write on the
   same slot;
2. sum the N colour samples into ``bg_sum`` (the background image × N);
3. build the 16-neighbour intra LBSP descriptors of the frame;
4. walk the samples, counting good ones up to ``required`` and keeping the
   minimum descriptor and sum distances of the counted ones.

Slab mode (``row_ext=E``, the row-sharded path of ``parallel/spatial.py``;
``pallas_consensus.py:640-700``): ``planes`` and ``pend_vals`` arrive as
[h + 2E, W] slabs of a shard's h owned rows, built by ``SpatialCtx.
extend_plain`` and ``extend_border``, whose halo rows carry the global row
clamps; every other tensor is owned-size. SuBSENSE's consensus, LOBSTER's
and the read-only walk (its planes only) take it; the fused step does not.

Also here: the pending-log helpers of ``pallas_consensus.py:258-320``;
LOBSTER's consensus, the same four steps with fixed thresholds and the
inter-frame descriptor distance only: the kernel ``consensus_lobster``
(replacing ``pallas_consensus.consensus_lobster_pallas``) beside its plain
version ``consensus_lobster_ref``; consensus v3's read-only walk, steps 3-4
on banks that are already current: ``consensus_read`` (replacing
``pallas_consensus.consensus_read_pallas`` and the retired
``attic/pallas_consensus2.py:consensus_walk_pallas``) beside
``consensus_read_ref``; and the fused whole step, steps 1-4 followed by the
feedback stage and the next frame's pending log: ``consensus_feedback``
(replacing ``pallas_consensus.consensus_feedback_pallas``) beside
``consensus_feedback_ref``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tracking_tpu_torch.ops import _native
from tracking_tpu_torch.ops.lbsp import BORDER, edge_pad, neighbor_stack, popcount16

# 5×5 neighbour offsets (x, y) in the reference's traversal order
NB5 = tuple(
    (x, y) for y in (2, 1, 0, -1, -2) for x in (-2, -1, 0, 1, 2) if not (x == 0 and y == 0)
)
_NB3 = ((-1, 1), (0, 1), (1, 1), (-1, 0), (1, 0), (-1, -1), (0, -1), (1, -1))
NB3_IN_NB5 = tuple(NB5.index(o) for o in _NB3)


def nb3_to_nb5_idx(o3: torch.Tensor) -> torch.Tensor:
    """Map a 3×3 offset draw (0..7) to its index in :data:`NB5`."""
    table = torch.tensor(NB3_IN_NB5, dtype=torch.int32, device=o3.device)
    return table[o3.long()]


def pack_pending_ctrl(upd1, slot1, u3, u5, slot3, slot5) -> torch.Tensor:
    """bit 0 upd1, bits 1-6 slot1, 7-11 u3 (NB5 index), 12-16 u5,
    17-22 slot3, 23-28 slot5."""
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    return i32(upd1) | (i32(slot1) << 1) | (i32(u3) << 7) | (i32(u5) << 12) | (i32(slot3) << 17) | (i32(slot5) << 23)


def pack_pending_vals(planes, intras, fires):
    """Per channel ``plane | intra << 8``; the spread fire bits ride
    channel 0's bits 24-25 (24 = 3×3 fired, 25 = 5×5)."""
    vals = [planes[c].to(torch.int32) | (intras[c].to(torch.int32) << 8) for c in range(len(planes))]
    vals[0] = vals[0] | (fires.to(torch.int32) << 24)
    return tuple(vals)


def unpack_pending_ctrl(w: torch.Tensor):
    return (
        (w & 1) != 0,  # upd1
        (w >> 1) & 63,  # slot1
        (w >> 7) & 31,  # u3 (NB5 index)
        (w >> 12) & 31,  # u5
        (w >> 17) & 63,  # slot3
        (w >> 23) & 63,  # slot5
    )


def interior_rep(a: torch.Tensor, border: int = 2) -> torch.Tensor:
    """Replicate the ROI interior's edge outward (the clamp of spread
    sources into the 2-px ROI interior)."""
    H, W = a.shape[-2], a.shape[-1]
    return edge_pad(a[..., border : H - border, border : W - border], border, border, border, border)


def shift_clamped(img: torch.Tensor, dy: int, dx: int, border: int = 2) -> torch.Tensor:
    """S(y, x) = img[clip(y−dy, border, H−border−1), clip(x−dx, …)] for
    any static dy, dx (``lbsp_family._shift_clamped``)."""
    H, W = img.shape[-2], img.shape[-1]
    rows = (torch.arange(H, device=img.device) - dy).clamp(border, H - border - 1)
    cols = (torch.arange(W, device=img.device) - dx).clamp(border, W - border - 1)
    return img.index_select(-2, rows).index_select(-1, cols)


def recip(c: float) -> float:
    """The f32 reciprocal of a constant divisor. XLA rewrites ``x / c`` for
    a constant ``c`` into ``x * (1/c)`` with the reciprocal rounded to f32,
    which is not always the IEEE quotient; the port multiplies by the same
    reciprocal wherever the reference divides by a constant."""
    return float(np.float32(1.0) / np.float32(c))


def thr_closed_form(v: torch.Tensor, delta: torch.Tensor, rel: float, div: float, hi_const: float) -> torch.Tensor:
    """The LBSP threshold of a u8 value with the LUT walk ``delta``
    (``pallas_consensus._thr_closed_form``); f32 ops in the reference's
    order, with its division by ``div`` and 4 taken as reciprocal products."""
    f32 = torch.float32
    vf = v.to(f32) * rel
    base = torch.clamp(torch.round(vf * recip(div)), 0.0, 255.0)
    lo = torch.ceil(vf * recip(4.0))
    hi = torch.full((), hi_const, dtype=f32, device=v.device)
    lower = torch.minimum(base, lo)
    upper = torch.maximum(base, hi)
    return torch.minimum(torch.maximum(base + delta.to(f32), lower), upper).to(torch.int32)


def color_desc_thresholds(R, unstable, gray: bool, min_cd: int, desc_off: int):
    """Per-pixel colour and descriptor thresholds from R(x) and the previous
    frame's unstable mask (``lbsp_family.py:902-914``)."""
    stab_off = torch.full((), float(min_cd // 5), dtype=torch.float32, device=R.device)
    zero = torch.zeros((), dtype=torch.float32, device=R.device)
    ct = (R * min_cd - torch.where(unstable, zero, stab_off)).to(torch.int32)
    if gray:
        ct = ct // 2
    n = torch.floor(R + 0.5).to(torch.int32)
    # XLA's shift-left gives 0 for shifts >= 32
    pow2 = torch.where((n >= 0) & (n < 32), torch.ones_like(n) << n.clamp(0, 31), torch.zeros_like(n))
    dt = pow2 + desc_off + torch.where(unstable, desc_off, 0).to(torch.int32)
    return ct, dt


def resolve_spread(vals, u3, u5, shift_src=None):
    """For each destination pixel: did its drawn 3×3 / 5×5 source fire, and
    the winning source's packed value per channel (3×3 wins).
    ``shift_src(c, dy, dx)`` gives channel c's values shifted with the ROI
    interior clamp (default :func:`shift_clamped` of ``vals[c]``; on a shard,
    a shift of the border-extended slab)."""
    C = len(vals)
    if shift_src is None:
        shift_src = lambda c, dy, dx: shift_clamped(vals[c], dy, dx)  # noqa: E731
    ok3 = torch.zeros(u3.shape, dtype=torch.bool, device=u3.device)
    ok5 = torch.zeros_like(ok3)
    for k, (dx, dy) in enumerate(NB5):
        fv = shift_src(0, dy, dx) >> 24
        if k in NB3_IN_NB5:
            ok3 = ok3 | ((u3 == k) & ((fv & 1) != 0))
        ok5 = ok5 | ((u5 == k) & ((fv & 2) != 0))
    u = torch.where(ok3, u3, u5)
    nbv = [torch.zeros(u3.shape, dtype=torch.int32, device=u3.device) for _ in range(C)]
    for k, (dx, dy) in enumerate(NB5):
        sel = u == k
        for c in range(C):
            nbv[c] = torch.where(sel, shift_src(c, dy, dx), nbv[c])
    return ok3, ok5, nbv


def apply_pending_ref(ctrl, vals, colors, descs, shift_src=None):
    """Replay a pending log into the banks (``_apply_pending_xla``).
    Returns new banks (C-tuples of [N, H, W] u8 / u16) and the per-channel
    post-apply colour sums (int32 [H, W]). ``shift_src``: see
    :func:`resolve_spread`."""
    C = len(colors)
    N = colors[0].shape[0]
    upd1, slot1, u3, u5, slot3, slot5 = unpack_pending_ctrl(ctrl)
    ok3, ok5, nbv = resolve_spread(vals, u3, u5, shift_src)
    okn = ok3 | ok5
    slotn = torch.where(ok3, slot3, slot5)
    slot_axis = torch.arange(N, dtype=torch.int32, device=ctrl.device)[:, None, None]
    m1 = upd1[None] & (slot1[None] == slot_axis)
    mn = okn[None] & (slotn[None] == slot_axis)
    new_colors, new_descs, bg_sum = [], [], []
    for c in range(C):
        own, nb = vals[c], nbv[c]
        col = torch.where(mn, (nb & 0xFF)[None], torch.where(m1, (own & 0xFF)[None], colors[c].to(torch.int32)))
        desc = torch.where(
            mn, ((nb >> 8) & 0xFFFF)[None], torch.where(m1, ((own >> 8) & 0xFFFF)[None], descs[c].to(torch.int32))
        )
        new_colors.append(col.to(torch.uint8))
        new_descs.append(desc.to(torch.uint16))
        bg_sum.append(col.sum(dim=0, dtype=torch.int32))
    return tuple(new_colors), tuple(new_descs), tuple(bg_sum)


def intra_descriptors(planes, thr):
    """C-tuple of u8 [H, W] -> (intra descriptors int32 ×C, neighbour stacks
    int16 [16, H, W] ×C); ``thr(v)`` maps values to LBSP thresholds."""
    descs, nbs = [], []
    for img in planes:
        nb = neighbor_stack(img)
        t = thr(img).to(torch.int16)
        d = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
        p = img.to(torch.int16)
        for k in range(16):
            d = d | (((nb[k] - p).abs() > t).to(torch.int32) << k)
        descs.append(d)
        nbs.append(nb)
    return tuple(descs), tuple(nbs)


def sample_good_ref(planes, colors, descs, intra, nbs, thr, color_thr, desc_thr):
    """Per sample, whether it is good, and its total descriptor and sum
    distances (``lbsp_family.py:922-952``): bool / int32 [N, H, W]."""
    C = len(planes)
    cds, dds = [], []
    for c in range(C):
        s_col = colors[c].to(torch.int32)
        s_desc = descs[c].to(torch.int32)
        cds.append((planes[c].to(torch.int32)[None] - s_col).abs())
        sthr = thr(colors[c])
        inter = torch.zeros_like(s_col)
        for k in range(16):
            inter = inter | (((nbs[c][k].to(torch.int32)[None] - s_col).abs() > sthr).to(torch.int32) << k)
        dds.append((popcount16(intra[c][None] ^ s_desc) + popcount16(inter ^ s_desc)) // 2)
    if C == 1:
        sum_d = torch.clamp((dds[0] // 4) * 15 + cds[0], max=255)
        good = (cds[0] <= color_thr) & (dds[0] <= desc_thr) & (sum_d <= color_thr)
        tot_desc, tot_sum = dds[0], sum_d
    else:
        sum_c = [torch.clamp((dds[c] // 2) * 15 + cds[c], max=255) for c in range(C)]
        sc = (color_thr * 3) // 2
        good = torch.ones_like(cds[0], dtype=torch.bool)
        for c in range(C):
            good = good & (cds[c] <= sc) & (sum_c[c] <= sc)
        tot_desc = sum(dds)
        tot_sum = sum(sum_c)
        good = good & (tot_desc <= desc_thr * 3) & (tot_sum <= color_thr * 3)
    return good, tot_desc, tot_sum


def walk_ref(planes, colors, descs, intra, nbs, thr, color_thr, desc_thr, required):
    """The sample walk, vectorised over the N samples: sample j is counted
    iff it is good and fewer than ``required`` earlier samples were good
    (the early exit)."""
    C = len(planes)
    good, tot_desc, tot_sum = sample_good_ref(planes, colors, descs, intra, nbs, thr, color_thr, desc_thr)
    g = good.to(torch.int32)
    before = torch.cumsum(g, dim=0, dtype=torch.int32) - g
    live = good & (before < required[None])
    count = live.to(torch.int32).sum(dim=0, dtype=torch.int32)
    mind = torch.where(live, tot_desc, 16 * C).amin(dim=0).to(torch.int32)
    mins = torch.where(live, tot_sum, 255 * C).amin(dim=0).to(torch.int32)
    return count, mind, mins


def _check_args(planes, *per_channel):
    C = len(planes)
    if C not in (1, 3) or any(len(x) != C for x in per_channel):
        raise ValueError(f"consensus takes 1 or 3 channels, got {C}")


def _slab_rows(x: torch.Tensor, E: int) -> torch.Tensor:
    return x[..., E : x.shape[-2] - E, :] if E else x


def consensus_read_ref(
    planes, colors, descs, lut_delta, R, unstable, required,
    rel: float, div: float, hi_const: float, min_cd: int, desc_off: int, row_ext: int = 0,
):
    """Plain torch read-only walk (consensus v3: the banks are already
    current, nothing is written). Same tensors as :func:`consensus_ref`
    without the pending log; ``required`` arrives ROI-zeroed. Returns
    (count, min_desc, min_sum, intra ×C), int32 [H, W]. ``row_ext=E``
    (for :func:`consensus_ref`'s slab mode): the planes are [H + 2E, W]
    slabs, cropped after the descriptors."""
    _check_args(planes, colors, descs)
    C = len(planes)
    thr = lambda v: thr_closed_form(v, lut_delta, rel, div, hi_const)  # noqa: E731
    intra, nbs = intra_descriptors(planes, thr)
    intra, nbs, planes = (tuple(_slab_rows(t, row_ext) for t in ts) for ts in (intra, nbs, planes))
    ct, dt = color_desc_thresholds(R, unstable, C == 1, min_cd, desc_off)
    count, mind, mins = walk_ref(planes, colors, descs, intra, nbs, thr, ct, dt, required)
    return count, mind, mins, intra


def slab_shift(slab: torch.Tensor, E: int, dy: int, dx: int, border: int = 2) -> torch.Tensor:
    """:func:`shift_clamped` on a border-extended [h + 2E, W] slab: the
    owned-shape S(y, x) = slab[E + y − dy, clip(x − dx, border, W−1−border)]
    (the slab's rows already carry the row clamp; ``SpatialCtx.shift_ext``)."""
    h = slab.shape[-2] - 2 * E
    W = slab.shape[-1]
    cols = (torch.arange(W, device=slab.device) - dx).clamp(border, W - border - 1)
    return slab[..., E - dy : E - dy + h, :].index_select(-1, cols)


def replay_ref(pend_ctrl, pend_vals, colors, descs, row_ext: int = 0):
    """:func:`apply_pending_ref` on owned pending values or, with
    ``row_ext=E``, on [H + 2E, W] slabs of them: the spread sources are
    shifts of the slab (``lbsp_family.py:1058-1069``)."""
    E = row_ext
    shift_src = (lambda c, dy, dx: slab_shift(pend_vals[c], E, dy, dx)) if E else None
    return apply_pending_ref(pend_ctrl, tuple(_slab_rows(v, E) for v in pend_vals), colors, descs, shift_src)


def consensus_ref(
    planes, colors, descs, pend_ctrl, pend_vals, lut_delta, R, unstable, required,
    rel: float, div: float, hi_const: float, min_cd: int, desc_off: int, row_ext: int = 0,
):
    """Plain torch. planes C-tuple u8 [H, W]; colors/descs C-tuples u8/u16
    [N, H, W]; pend_ctrl int32 [H, W]; pend_vals C-tuple int32; lut_delta
    int32 0-d; R f32; unstable bool; required int32 [H, W]. Returns
    (count, min_desc, min_sum, intra ×C, bg_sum ×C, colors, descs), the
    maps int32 and the banks new tensors. ``row_ext=E``: planes and
    pend_vals are [H + 2E, W] slabs (module docstring); the spread sources
    are shifts of the pending slab (:func:`replay_ref`) and the
    descriptors are taken on the plane slab and cropped."""
    _check_args(planes, colors, descs, pend_vals)
    colors, descs, bg_sum = replay_ref(pend_ctrl, pend_vals, colors, descs, row_ext)
    count, mind, mins, intra = consensus_read_ref(
        planes, colors, descs, lut_delta, R, unstable, required, rel, div, hi_const, min_cd, desc_off, row_ext
    )
    return count, mind, mins, intra, bg_sum, colors, descs


def consensus(
    planes, colors, descs, pend_ctrl, pend_vals, lut_delta, R, unstable, required,
    rel: float, div: float, hi_const: float, min_cd: int, desc_off: int, row_ext: int = 0,
):
    """Same contract as :func:`consensus_ref`. CPU tensors take the plain
    version. CUDA tensors launch the kernel, which updates ``colors`` and
    ``descs`` IN PLACE (each pixel writes at most two of its own slots) and
    returns them; ``row_ext`` > 0 runs its slab mode (E >= 2)."""
    if planes[0].device.type == "cpu":
        return consensus_ref(
            planes, colors, descs, pend_ctrl, pend_vals, lut_delta, R, unstable, required,
            rel, div, hi_const, min_cd, desc_off, row_ext,
        )
    _check_args(planes, colors, descs, pend_vals)
    C = len(planes)
    H, W = R.shape
    Hp = H + 2 * row_ext
    N = colors[0].shape[0]
    if N > 63:
        raise ValueError("the pending log's 6-bit slots hold at most 63 samples")
    _check_row_ext(row_ext)
    req = _native.require
    for c in range(C):
        req(planes[c], f"planes[{c}]", torch.uint8, (Hp, W))
        req(colors[c], f"colors[{c}]", torch.uint8, (N, H, W))
        req(descs[c], f"descs[{c}]", torch.uint16, (N, H, W))
        req(pend_vals[c], f"pend_vals[{c}]", torch.int32, (Hp, W))
    req(pend_ctrl, "pend_ctrl", torch.int32, (H, W))
    req(R, "R", torch.float32, (H, W))
    req(unstable, "unstable", torch.bool, (H, W))
    req(required, "required", torch.int32, (H, W))
    req(lut_delta, "lut_delta", torch.int32, ())
    maps = torch.empty((3 + 2 * C, H, W), dtype=torch.int32, device=planes[0].device)
    count, mind, mins = maps[0], maps[1], maps[2]
    intra, bg_sum = maps[3 : 3 + C], maps[3 + C :]
    ptr = lambda ts, c: ts[c].data_ptr() if c < C else None  # noqa: E731
    rc = _native.library().tt_consensus(
        ptr(planes, 0), ptr(planes, 1), ptr(planes, 2),
        ptr(colors, 0), ptr(colors, 1), ptr(colors, 2),
        ptr(descs, 0), ptr(descs, 1), ptr(descs, 2),
        pend_ctrl.data_ptr(),
        ptr(pend_vals, 0), ptr(pend_vals, 1), ptr(pend_vals, 2),
        R.data_ptr(), unstable.data_ptr(), required.data_ptr(), lut_delta.data_ptr(),
        count.data_ptr(), mind.data_ptr(), mins.data_ptr(), intra.data_ptr(), bg_sum.data_ptr(),
        C, N, H, W, rel, div, hi_const, min_cd, desc_off, row_ext, _native.stream_ptr(),
    )
    _native.check(rc, "consensus")
    _native.count_launch("consensus")
    return count, mind, mins, tuple(intra.unbind(0)), tuple(bg_sum.unbind(0)), colors, descs


def _check_row_ext(row_ext: int) -> None:
    if row_ext == 1 or row_ext < 0:
        raise ValueError(f"row_ext must be 0 or >= 2 (the walk reads rows +-2), got {row_ext}")


def consensus_read(
    planes, colors, descs, lut_delta, R, unstable, required,
    rel: float, div: float, hi_const: float, min_cd: int, desc_off: int, row_ext: int = 0,
):
    """Same contract as :func:`consensus_read_ref`. CPU tensors take the
    plain version. CUDA tensors launch ``read_walk_kernel``
    (``csrc/consensus.cu``, replacing ``pallas_consensus.consensus_read_pallas``
    and the retired ``attic/pallas_consensus2.py:consensus_walk_pallas``),
    which only reads the banks; ``row_ext`` > 0 runs its slab mode (E >= 2)."""
    if planes[0].device.type == "cpu":
        return consensus_read_ref(
            planes, colors, descs, lut_delta, R, unstable, required, rel, div, hi_const, min_cd, desc_off, row_ext
        )
    _check_args(planes, colors, descs)
    _check_row_ext(row_ext)
    C = len(planes)
    H, W = R.shape
    N = colors[0].shape[0]
    if N > 63:
        raise ValueError("the walk's queue holds sample counts in 6 bits: at most 63 samples")
    req = _native.require
    for c in range(C):
        req(planes[c], f"planes[{c}]", torch.uint8, (H + 2 * row_ext, W))
        req(colors[c], f"colors[{c}]", torch.uint8, (N, H, W))
        req(descs[c], f"descs[{c}]", torch.uint16, (N, H, W))
    req(R, "R", torch.float32, (H, W))
    req(unstable, "unstable", torch.bool, (H, W))
    req(required, "required", torch.int32, (H, W))
    req(lut_delta, "lut_delta", torch.int32, ())
    maps = torch.empty((3 + C, H, W), dtype=torch.int32, device=R.device)
    count, mind, mins, intra = maps[0], maps[1], maps[2], maps[3:]
    ptr = lambda ts, c: ts[c].data_ptr() if c < C else None  # noqa: E731
    rc = _native.library().tt_consensus_read(
        ptr(planes, 0), ptr(planes, 1), ptr(planes, 2),
        ptr(colors, 0), ptr(colors, 1), ptr(colors, 2),
        ptr(descs, 0), ptr(descs, 1), ptr(descs, 2),
        R.data_ptr(), unstable.data_ptr(), required.data_ptr(), lut_delta.data_ptr(),
        count.data_ptr(), mind.data_ptr(), mins.data_ptr(), intra.data_ptr(),
        C, N, H, W, rel, div, hi_const, min_cd, desc_off, row_ext, _native.stream_ptr(),
    )
    _native.check(rc, "consensus_read")
    _native.count_launch("consensus_read")
    return count, mind, mins, tuple(intra.unbind(0))


# -- the fused whole step --------------------------------------------------------


def roi_map(h: int, w: int, device=None) -> torch.Tensor:
    """The LBSP ROI: bool [h, w], the 2-px border outside."""
    roi = torch.zeros((h, w), dtype=torch.bool, device=device)
    roi[BORDER : h - BORDER, BORDER : w - BORDER] = True
    return roi


def _required_map(required, h: int, w: int, device) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(required, dtype=torch.int32, device=device), (h, w)).contiguous()


def consensus_feedback_ref(
    planes, colors, descs, pend_ctrl, pend_vals, lut_delta, R, unstable, required,
    last_color, last_desc, bits, masks, f32_state, scalars,
    rel: float, div: float, hi_const: float, min_cd: int, desc_off: int, use3x3_global: bool, k,
):
    """Plain torch whole step (``pallas_consensus.consensus_feedback_pallas``):
    :func:`consensus_ref` with the ROI-zeroed requirement, frame 0's adoption
    of this frame as ``last_color`` / ``last_desc``, the feedback stage
    (``ops/feedback.feedback``) with the TRUE requirement, then the next
    frame's pending log and the flags word (bit 0 is_fg, 1 unstable, 2 nz,
    3 curr_blink, 4 blinks_pre).

    Tensors as in :func:`consensus_ref`, plus ``required`` (an int or an
    int32 [H, W] map: the true requirement), ``last_color`` / ``last_desc``
    (C-tuples of u8 / u16), ``bits`` (int32 [4, H, W]), ``masks``
    (last_final, blinks_old, last_blink_mask, last_raw, last_dil_inv;
    nonzero = set), ``f32_state`` (mean_last, dmin_lt, dmin_st, raw_lt,
    raw_st, final_lt, final_st, T, v) and ``scalars`` (a_lt, a_st,
    lr_lower, lr_upper, cooldown, t as 0-d tensors); ``k`` the
    ``FeedbackConsts``. Returns (flags, pend_ctrl, pend_vals ×C,
    (mean_last, dmin_lt, dmin_st, raw_lt, raw_st, T, v, R), bg_sum ×C,
    colors, descs)."""
    from tracking_tpu_torch.ops.feedback import feedback

    _check_args(planes, colors, descs, pend_vals, last_color, last_desc)
    C = len(planes)
    H, W = planes[0].shape
    dev = planes[0].device
    roi = roi_map(H, W, dev)
    req = _required_map(required, H, W, dev)
    count, mind, mins, intra, bg_sum, colors, descs = consensus_ref(
        planes, colors, descs, pend_ctrl, pend_vals, lut_delta, R, unstable, torch.where(roi, req, 0),
        rel, div, hi_const, min_cd, desc_off,
    )
    a_lt, a_st, lr_lower, lr_upper, cooldown, t = scalars
    first = t == 0
    mean_last, dmin_lt, dmin_st, raw_lt, raw_st, final_lt, final_st, T, v = f32_state
    last_final, blinks_old, last_blink_mask, last_raw, last_dil_inv = masks
    fb = feedback(
        dict(
            count=count, mind=mind, mins=mins, required=req, roi=roi, planes=planes, intras=intra,
            last_colors=tuple(torch.where(first, planes[c], last_color[c]) for c in range(C)),
            last_descs=tuple(torch.where(first, intra[c], last_desc[c].to(torch.int32)) for c in range(C)),
            bits=tuple(bits[i] for i in range(4)),
            mean_last=mean_last, dmin_lt=dmin_lt, dmin_st=dmin_st, raw_lt=raw_lt, raw_st=raw_st,
            final_lt=final_lt, final_st=final_st, R=R, T=T, v=v,
            last_final=last_final, blinks_old=blinks_old, last_blink_mask=last_blink_mask,
            last_raw=last_raw, last_dil_inv=last_dil_inv,
        ),
        (a_lt, a_st, lr_lower, lr_upper, cooldown),
        C=C, N=colors[0].shape[0], use3x3_global=use3x3_global, k=k,
    )
    i32 = lambda m: m.to(torch.int32)  # noqa: E731
    flags = i32(fb.is_fg) | (i32(fb.unstable) << 1) | (i32(fb.nz) << 2) | (i32(fb.curr_blink) << 3) | (
        i32(fb.blinks_pre) << 4
    )
    new_ctrl = pack_pending_ctrl(fb.upd1, fb.slot1, nb3_to_nb5_idx(fb.o3), fb.o5, fb.slot3, fb.slot5)
    new_vals = pack_pending_vals(planes, intra, i32(fb.fire3) | (i32(fb.fire5) << 1))
    f32_out = (fb.mean_last, fb.dmin_lt, fb.dmin_st, fb.raw_lt, fb.raw_st, fb.T, fb.v, fb.R)
    return flags, new_ctrl, new_vals, f32_out, bg_sum, colors, descs


def _feedback_consts_f32(k) -> list:
    """The ``FbConsts`` of ``csrc/feedback.cuh`` in field order: the f32
    roundings of the Python doubles the plain version uses (``v_decr / 4``
    and ``v_decr / 2`` are formed in double first, as there)."""
    return [k.t_incr, k.t_decr, k.t_lower, k.v_incr, k.v_decr, k.v_decr / 4, k.v_decr / 2, k.r_var,
            k.rdist_min, k.ratio_min, k.ghost_s_min, k.ghost_d_max]


def consensus_feedback(
    planes, colors, descs, pend_ctrl, pend_vals, lut_delta, R, unstable, required,
    last_color, last_desc, bits, masks, f32_state, scalars,
    rel: float, div: float, hi_const: float, min_cd: int, desc_off: int, use3x3_global: bool, k,
):
    """Same contract as :func:`consensus_feedback_ref`. CPU tensors take the
    plain version. CUDA tensors launch ``fused_kernel``
    (``csrc/consensus.cu``, replacing
    ``pallas_consensus.consensus_feedback_pallas``), which updates ``colors``
    and ``descs`` IN PLACE and writes the new pending log to new tensors (the
    old one is read by the neighbours' replay). ``t`` and the other scalars
    stay on the card."""
    if planes[0].device.type == "cpu":
        return consensus_feedback_ref(
            planes, colors, descs, pend_ctrl, pend_vals, lut_delta, R, unstable, required,
            last_color, last_desc, bits, masks, f32_state, scalars,
            rel, div, hi_const, min_cd, desc_off, use3x3_global, k,
        )
    _check_args(planes, colors, descs, pend_vals, last_color, last_desc)
    C = len(planes)
    H, W = planes[0].shape
    N = colors[0].shape[0]
    if N > 63:
        raise ValueError("the pending log's 6-bit slots hold at most 63 samples")
    dev = planes[0].device
    required = _required_map(required, H, W, dev)
    req = _native.require
    for c in range(C):
        req(planes[c], f"planes[{c}]", torch.uint8, (H, W))
        req(colors[c], f"colors[{c}]", torch.uint8, (N, H, W))
        req(descs[c], f"descs[{c}]", torch.uint16, (N, H, W))
        req(pend_vals[c], f"pend_vals[{c}]", torch.int32, (H, W))
        req(last_color[c], f"last_color[{c}]", torch.uint8, (H, W))
        req(last_desc[c], f"last_desc[{c}]", torch.uint16, (H, W))
    req(pend_ctrl, "pend_ctrl", torch.int32, (H, W))
    req(R, "R", torch.float32, (H, W))
    req(unstable, "unstable", torch.bool, (H, W))
    req(required, "required", torch.int32, (H, W))
    req(lut_delta, "lut_delta", torch.int32, ())
    req(bits, "bits", torch.int32, (4, H, W))
    if len(masks) != 5 or len(f32_state) != 9 or len(scalars) != 6:
        raise ValueError("consensus_feedback takes 5 masks, 9 f32 maps and 6 scalars")
    for i, m in enumerate(masks):
        if m.dtype not in (torch.uint8, torch.bool):
            raise ValueError(f"masks[{i}]: expected uint8 or bool, got {m.dtype}")
        req(m, f"masks[{i}]", m.dtype, (H, W))
    for i, f in enumerate(f32_state):
        req(f, f"f32_state[{i}]", torch.float32, (H, W))
    # the frame scalars as 0-d tensors on the card, each read by the kernel
    # where it lies (converted only when the caller's type differs)
    scal = [torch.as_tensor(s, device=dev).to(dt).contiguous()
            for s, dt in zip(scalars, [torch.float32] * 4 + [torch.int32] * 2)]
    out_i = torch.empty((2 + 2 * C, H, W), dtype=torch.int32, device=dev)
    out_f = torch.empty((8, H, W), dtype=torch.float32, device=dev)
    per_c = lambda ts: [ts[c].data_ptr() if c < C else None for c in range(3)]  # noqa: E731
    ptrs = (
        per_c(planes) + per_c(colors) + per_c(descs) + [pend_ctrl.data_ptr()] + per_c(pend_vals)
        + [R.data_ptr(), unstable.data_ptr(), required.data_ptr(), lut_delta.data_ptr()]
        + per_c(last_color) + per_c(last_desc) + [bits.data_ptr()]
        + [m.data_ptr() for m in masks] + [f.data_ptr() for f in f32_state]
        + [x.data_ptr() for x in scal] + [out_i.data_ptr(), out_f.data_ptr()]
    )
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_consts = (ctypes.c_float * 12)(*_feedback_consts_f32(k))
    rc = _native.library().tt_consensus_feedback(
        c_ptrs, c_consts, C, N, H, W, rel, div, hi_const, min_cd, desc_off, int(use3x3_global),
        _native.stream_ptr(),
    )
    _native.check(rc, "consensus_feedback")
    _native.count_launch("consensus_feedback")
    vals, bg_sum = out_i[2 : 2 + C], out_i[2 + C :]
    return (
        out_i[0], out_i[1], tuple(vals.unbind(0)), tuple(out_f.unbind(0)), tuple(bg_sum.unbind(0)), colors, descs
    )


# -- LOBSTER ------------------------------------------------------------------


def thr_lobster(v: torch.Tensor, rel: float, offset: float, div: float) -> torch.Tensor:
    """LOBSTER's closed-form LBSP threshold of a u8 value
    (``lbsp_family.LOBSTER._thr_fn``): ``clip(rint((v·rel + offset)/div),
    0, 255)`` in f32, the division taken as XLA's reciprocal product."""
    raw = (v.to(torch.float32) * rel + offset) * recip(div)
    return torch.clamp(torch.round(raw), 0.0, 255.0).to(torch.int32)


def sample_good_lobster_ref(planes, colors, descs, nbs, thr, c_sc: int, d_sc: int, c_tot: int, d_tot: int):
    """Per sample, whether it is good for LOBSTER (``lbsp_family.py:518-539``):
    the descriptor distance is the inter-frame Hamming distance only and the
    thresholds are fixed. bool [N, H, W]."""
    C = len(planes)
    cds, dds = [], []
    for c in range(C):
        s_col = colors[c].to(torch.int32)
        s_desc = descs[c].to(torch.int32)
        cds.append((planes[c].to(torch.int32)[None] - s_col).abs())
        sthr = thr(colors[c])
        inter = torch.zeros_like(s_col)
        for k in range(16):
            inter = inter | (((nbs[c][k].to(torch.int32)[None] - s_col).abs() > sthr).to(torch.int32) << k)
        dds.append(popcount16(inter ^ s_desc))
    good = torch.ones_like(cds[0], dtype=torch.bool)
    for c in range(C):
        good = good & (cds[c] <= c_sc) & (dds[c] <= d_sc)
    if C > 1:
        good = good & (sum(cds) <= c_tot) & (sum(dds) <= d_tot)
    return good


def consensus_lobster_ref(
    planes, colors, descs, pend_ctrl, pend_vals,
    rel: float, offset: float, div: float, c_sc: int, d_sc: int, c_tot: int, d_tot: int, req: int,
    row_ext: int = 0,
):
    """Plain torch LOBSTER consensus. planes C-tuple u8 [H, W]; colors /
    descs C-tuples u8 / u16 [N, H, W]; pend_ctrl int32 [H, W] (3×3 spreads
    only); pend_vals C-tuple int32. Returns (count, intra ×C, bg_sum ×C,
    colors, descs), the maps int32 and the banks new tensors. ``row_ext=E``:
    the slab mode of :func:`consensus_ref` (planes and pend_vals [H + 2E, W]
    slabs; the spreads read the pending slab, ``lbsp_family.py:590-599``)."""
    _check_args(planes, colors, descs, pend_vals)
    colors, descs, bg_sum = replay_ref(pend_ctrl, pend_vals, colors, descs, row_ext)
    thr = lambda v: thr_lobster(v, rel, offset, div)  # noqa: E731
    intra, nbs = intra_descriptors(planes, thr)
    intra, nbs, planes = (tuple(_slab_rows(t, row_ext) for t in ts) for ts in (intra, nbs, planes))
    good = sample_good_lobster_ref(planes, colors, descs, nbs, thr, c_sc, d_sc, c_tot, d_tot)
    count = torch.clamp(good.sum(dim=0, dtype=torch.int32), max=req)  # the walk stops at req
    return count, intra, bg_sum, colors, descs


def consensus_lobster(
    planes, colors, descs, pend_ctrl, pend_vals,
    rel: float, offset: float, div: float, c_sc: int, d_sc: int, c_tot: int, d_tot: int, req: int,
    row_ext: int = 0,
):
    """Same contract as :func:`consensus_lobster_ref`. CPU tensors take the
    plain version. CUDA tensors launch the kernel (``csrc/consensus.cu``,
    replacing ``pallas_consensus.consensus_lobster_pallas``), which updates
    ``colors`` and ``descs`` IN PLACE and returns them; ``row_ext`` > 0 runs
    its slab mode (E >= 2)."""
    if planes[0].device.type == "cpu":
        return consensus_lobster_ref(
            planes, colors, descs, pend_ctrl, pend_vals, rel, offset, div, c_sc, d_sc, c_tot, d_tot, req, row_ext
        )
    _check_args(planes, colors, descs, pend_vals)
    _check_row_ext(row_ext)
    C = len(planes)
    H, W = pend_ctrl.shape
    Hp = H + 2 * row_ext
    N = colors[0].shape[0]
    if N > 63:
        raise ValueError("the pending log's 6-bit slots hold at most 63 samples")
    req_ = _native.require
    for c in range(C):
        req_(planes[c], f"planes[{c}]", torch.uint8, (Hp, W))
        req_(colors[c], f"colors[{c}]", torch.uint8, (N, H, W))
        req_(descs[c], f"descs[{c}]", torch.uint16, (N, H, W))
        req_(pend_vals[c], f"pend_vals[{c}]", torch.int32, (Hp, W))
    req_(pend_ctrl, "pend_ctrl", torch.int32, (H, W))
    maps = torch.empty((1 + 2 * C, H, W), dtype=torch.int32, device=planes[0].device)
    count, intra, bg_sum = maps[0], maps[1 : 1 + C], maps[1 + C :]
    ptr = lambda ts, c: ts[c].data_ptr() if c < C else None  # noqa: E731
    rc = _native.library().tt_consensus_lobster(
        ptr(planes, 0), ptr(planes, 1), ptr(planes, 2),
        ptr(colors, 0), ptr(colors, 1), ptr(colors, 2),
        ptr(descs, 0), ptr(descs, 1), ptr(descs, 2),
        pend_ctrl.data_ptr(),
        ptr(pend_vals, 0), ptr(pend_vals, 1), ptr(pend_vals, 2),
        count.data_ptr(), intra.data_ptr(), bg_sum.data_ptr(),
        C, N, H, W, rel, offset, div, c_sc, d_sc, c_tot, d_tot, req, row_ext, _native.stream_ptr(),
    )
    _native.check(rc, "consensus_lobster")
    _native.count_launch("consensus_lobster")
    return count, tuple(intra.unbind(0)), tuple(bg_sum.unbind(0)), colors, descs
