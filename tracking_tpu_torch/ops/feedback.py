"""SuBSENSE feedback and update-decision stage, counterpart of
``tracking_tpu/ops/pallas_feedback.py`` (``derive_draws``, ``_core``,
``feedback_xla``). The stage is elementwise; it holds no kernel.

Everything between the sample consensus and the post-processing of one
frame: the unstable-region mask, rolling means, ghost detection, the
stochastic update decisions, the R/T/v controllers, blink bookkeeping and
the nonzero-descriptor map. The f32 arithmetic keeps the reference's
operation order exactly, so the state stays bit-identical; every f32
division by a constant is the reciprocal product XLA makes of it
(``consensus.recip``); other divisions take a device tensor as divisor,
since CUDA divides by a host scalar as a multiply by its reciprocal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tracking_tpu_torch.ops.consensus import recip
from tracking_tpu_torch.ops.lbsp import popcount16


class FeedbackConsts(NamedTuple):
    t_incr: float
    t_decr: float
    t_lower: float
    v_incr: float
    v_decr: float
    r_var: float
    rdist_min: float
    ratio_min: float
    ghost_s_min: float
    ghost_d_max: float


class FeedbackOut(NamedTuple):
    is_fg: torch.Tensor
    unstable: torch.Tensor
    nz: torch.Tensor
    curr_blink: torch.Tensor
    blinks_pre: torch.Tensor
    upd1: torch.Tensor
    slot1: torch.Tensor
    fire3: torch.Tensor
    fire5: torch.Tensor
    o3: torch.Tensor
    o5: torch.Tensor
    slot3: torch.Tensor
    slot5: torch.Tensor
    mean_last: torch.Tensor
    dmin_lt: torch.Tensor
    dmin_st: torch.Tensor
    raw_lt: torch.Tensor
    raw_st: torch.Tensor
    T: torch.Tensor
    v: torch.Tensor
    R: torch.Tensor


def _field(b, lo, nbits):
    return (b >> lo) & ((1 << nbits) - 1)


def derive_draws(bits, n_samples: int):
    """[4, ...] int32 random words -> (u_cd, u_self, u_nb, slot_cd,
    slot_self, slot3, slot5, o3, o5); mutually exclusive decisions share a
    field."""
    scale = 2.0 ** -23
    u1 = _field(bits[0], 9, 23).to(torch.float32) * scale
    u_nb = _field(bits[1], 9, 23).to(torch.float32) * scale
    slot1 = (_field(bits[2], 0, 16) * n_samples) >> 16
    slotn = (_field(bits[2], 16, 16) * n_samples) >> 16
    o3 = (_field(bits[3], 0, 16) * 8) >> 16
    o5 = (_field(bits[3], 16, 16) * 24) >> 16
    return u1, u1, u_nb, slot1, slot1, slotn, slotn, o3, o5


def _core(
    count, mind, mins, required, roi,
    planes, intras, last_colors, last_descs, bits,
    mean_last, dmin_lt, dmin_st, raw_lt, raw_st, final_lt, final_st,
    R, T, v, last_final, blinks_old, last_blink_mask, last_raw, last_dil_inv,
    a_lt, a_st, lr_lower, lr_upper, cooldown,
    *, C, N, use3x3_global, k: FeedbackConsts,
) -> FeedbackOut:
    """Per-pixel feedback math. Integer maps int32, float maps f32, scalars
    0-d tensors on the maps' device."""
    dev = count.device
    f32 = torch.float32
    c = lambda x: torch.full((), x, dtype=f32, device=dev)  # noqa: E731
    max_color, max_desc = 255 * C, 16 * C

    roi_b = roi != 0
    is_fg = (count < required) & roi_b
    is_bg = ~is_fg & roi_b

    unstable = (R > k.rdist_min) | ((raw_lt - final_lt) > k.ratio_min) | ((raw_st - final_st) > k.ratio_min)

    color_ld = sum((last_colors[ci] - planes[ci]).abs() for ci in range(C))
    desc_ld = sum(popcount16(last_descs[ci] ^ intras[ci]) for ci in range(C))
    nld = (color_ld.to(f32) * recip(max_color) + desc_ld.to(f32) * recip(max_desc)) * 0.5
    mean_last = mean_last * (1 - a_st) + nld * a_st

    nmd_base = (mins.to(f32) * recip(max_color) + mind.to(f32) * recip(max_desc)) * 0.5
    nmd_fg = torch.minimum(c(1.0), nmd_base + (required - count).to(f32) / required.to(f32))
    nmd = torch.where(is_fg, nmd_fg, nmd_base)
    dmin_lt = dmin_lt * (1 - a_lt) + nmd * a_lt
    dmin_st = dmin_st * (1 - a_st) + nmd * a_st
    fg_f = is_fg.to(f32)
    raw_lt = raw_lt * (1 - a_lt) + fg_f * a_lt
    raw_st = raw_st * (1 - a_st) + fg_f * a_st

    (u_cd, u_self, u_nb, slot_cd, slot_self, slot3, slot5, o3, o5) = derive_draws(bits, N)
    lr_f = torch.maximum(torch.ceil(T), c(1.0))
    upd_cd = is_fg & (cooldown > 0) & (u_cd * k.t_lower < 1.0)
    upd_self = is_bg & (u_self * lr_f < 1.0)
    upd1 = upd_cd | upd_self
    slot1 = torch.where(upd_cd, slot_cd, slot_self)

    use3_src = ~unstable if use3x3_global else torch.zeros_like(unstable)
    ghost = (raw_st > k.ghost_s_min) & (mean_last < k.ghost_d_max)
    rate5_f = torch.floor(lr_f * 0.5) + 1.0
    lower_f = torch.maximum(lr_lower, c(1.0))
    fire_lo = ghost & (u_nb * lower_f < 1.0)
    fire3 = is_bg & use3_src & ((u_nb * lr_f < 1.0) | fire_lo)
    fire5 = is_bg & ~use3_src & ((u_nb * rate5_f < 1.0) | fire_lo)

    dmin_max = torch.maximum(dmin_lt, dmin_st)
    dmin_min = torch.minimum(dmin_lt, dmin_st)
    last_final_fg = last_final != 0
    t_up = last_final_fg | ((dmin_min < k.ratio_min) & is_fg)
    T_inc = T + c(k.t_incr) / (dmin_max * v)
    T_dec = T - (v * k.t_decr) / dmin_max
    T = torch.where(t_up, torch.where(T < lr_upper, T_inc, T), torch.where(T > lr_lower, T_dec, T))
    T = torch.minimum(torch.maximum(T, lr_lower), lr_upper)

    v_up = (dmin_max > k.ratio_min) & (blinks_old != 0)
    v_dec_amt = torch.where(last_final_fg, c(k.v_decr / 4), torch.where(unstable, c(k.v_decr / 2), c(k.v_decr)))
    v_decd = torch.maximum(v - v_dec_amt, c(k.v_decr))
    v = torch.where(v_up, v + k.v_incr, torch.where(v > k.v_decr, v_decd, v))

    r_limit = 1.0 + dmin_min * 2.0
    r_limit = r_limit * r_limit
    R = torch.where(R < r_limit, R + (v - k.v_decr) * k.r_var, torch.maximum(R - c(k.r_var) / v, c(1.0)))

    nz = sum(popcount16(intras[ci]) for ci in range(C)) >= (2 if C == 1 else 4)

    curr_blink = is_fg != (last_raw != 0)
    blinks_pre = (curr_blink | (last_blink_mask != 0)) & (last_dil_inv != 0)

    return FeedbackOut(
        is_fg=is_fg, unstable=unstable, nz=nz, curr_blink=curr_blink, blinks_pre=blinks_pre,
        upd1=upd1, slot1=slot1, fire3=fire3, fire5=fire5, o3=o3, o5=o5, slot3=slot3, slot5=slot5,
        mean_last=mean_last, dmin_lt=dmin_lt, dmin_st=dmin_st, raw_lt=raw_lt, raw_st=raw_st,
        T=T, v=v, R=R,
    )


def feedback(tensors, scalars, *, C, N, use3x3_global, k) -> FeedbackOut:
    """Whole-map feedback (``feedback_xla``): non-f32 maps are widened to
    int32 first. ``scalars``: (a_lt, a_st, lr_lower, lr_upper, cooldown)."""
    a_lt, a_st, lr_lower, lr_upper, cooldown = scalars

    def widen(x):
        return x if x.dtype == torch.float32 else x.to(torch.int32)

    tensors = {
        key: tuple(widen(x) for x in val) if isinstance(val, tuple) else widen(val)
        for key, val in tensors.items()
    }
    return _core(
        **tensors, a_lt=a_lt, a_st=a_st, lr_lower=lr_lower, lr_upper=lr_upper, cooldown=cooldown,
        C=C, N=N, use3x3_global=use3x3_global, k=k,
    )
