"""FGD's Bayes-table phase: the CUDA kernel ``fgd_tables`` (``csrc/fgd.cu``,
replacing ``tracking_tpu/ops/pallas_fgd.py:fgd_tables_pallas``) and its plain
version ``fgd_tables_ref`` (``tracking_tpu/bgs/fgd.py:_Table`` and
``_tables_phase``).

Each pixel keeps two mode-major tables: a colour table (``ct``, N2c entries
of C quantised colour bytes) and a co-occurrence table (``cc``, N2cc entries
of 2C bytes: the previous frame's and this frame's colour), with the
statistics P(v) and P(v, bg) of every entry stored as ``STAT_DTYPE`` and
computed in f32. Per frame, for each table: the first entry whose key equals
the pixel's key and whose P > 0 is the match; the pixel is background by
that table where the match ranks among the N1 entries of largest P (lower
index first among equal P) and 2·Pb > T·P. Stationary pixels take the colour
table's verdict, changed pixels (``changed``) the co-occurrence table's; the
first frame is all background. A pixel foreground for ``absorbFrames``
frames in a row is labelled background for the updates. Then every entry of
a table decays by 1 − alpha2 and the match is reinforced, or, with no match,
the entry of least P (the first among equals) is replaced by the key with
P = alpha2, only where the table is updated: the colour table where the
pixel did not change (or on the first frame), the co-occurrence table where
it did.

Everything is computed in f32 and stored once per leaf (round to nearest
even), as the reference does; the constants are the reference's Python
doubles rounded once to f32.
"""

from __future__ import annotations

import torch

from tracking_tpu_torch.ops import _native

TABLE_LEAVES = ("ct_key", "ct_P", "ct_Pb", "cc_key", "cc_P", "cc_Pb", "fg_age")
MAX_KEY_BYTES = 8  # the key bytes a pixel that the kernel holds (csrc/fgd.cu kMaxKey)


def quant(planes, levels: int):
    """Quantise u8 planes to ``levels`` (a power of two) by a right shift."""
    shift = 8 - (int(levels).bit_length() - 1)
    return tuple(p >> shift for p in planes)


def _lookup(keys, P, Pb, key, n1: int, T: float):
    """The first match (N where none), the table's verdict and the first
    least-P entry of one table. keys u8 [N, Ck, H, W]; P, Pb f32 [N, H, W];
    key u8 [Ck, H, W]."""
    N = P.shape[0]
    kidx = torch.arange(N, dtype=torch.int32, device=P.device)[:, None, None]
    match = (keys == key[None]).all(dim=1) & (P > 0.0)
    fi = torch.where(match, kidx, N).amin(dim=0)
    has = fi < N
    at_fi = fi.clamp(max=N - 1).long()[None]
    P_m = torch.where(has, P.gather(0, at_fi)[0], 0.0)
    Pb_m = torch.where(has, Pb.gather(0, at_fi)[0], 0.0)
    idx_m = torch.where(has, fi, 0)
    rank = ((P > P_m[None]) | ((P == P_m[None]) & (kidx < idx_m[None]))).sum(dim=0, dtype=torch.int32)
    bg = has & (rank < n1) & (2.0 * Pb_m > T * P_m)
    # the first entry of least P (strict <, as an argmin keeps the first)
    min_idx = torch.where(P == P.amin(dim=0, keepdim=True), kidx, N).amin(dim=0)
    return fi, bg, min_idx


def _update(keys, P, Pb, key, fi, min_idx, do, lab_bg, alpha: float, stat_dtype):
    """Decay every entry; reinforce the match or replace the first least-P
    entry, only where ``do``. Returns new (keys, P, Pb)."""
    N = P.shape[0]
    kidx = torch.arange(N, dtype=torch.int32, device=P.device)[:, None, None]
    has = fi < N
    at = torch.where(has, kidx == fi[None], kidx == min_idx[None]) & do[None]
    lab = lab_bg.to(torch.float32)
    p_dec = P * (1.0 - alpha)
    pb_dec = Pb * (1.0 - alpha)
    a_lab = alpha * lab
    p_new = torch.where(has, p_dec + alpha, alpha)
    pb_new = torch.where(has, pb_dec + a_lab, a_lab)
    new_keys = torch.where((at & ~has[None])[:, None], key[None], keys)
    new_P = torch.where(do[None], torch.where(at, p_new, p_dec), P).to(stat_dtype)
    new_Pb = torch.where(do[None], torch.where(at, pb_new, pb_dec), Pb).to(stat_dtype)
    return new_keys, new_P, new_Pb


def fgd_tables_ref(cfg, state, ckey, cckey, changed, first):
    """Plain torch. ``state`` holds the ``TABLE_LEAVES`` (keys u8 [N, Ck, H,
    W], P / Pb [N, H, W] f16 or f32, fg_age int32 [H, W]); ckey u8 [C, H, W],
    cckey u8 [2C, H, W]; changed bool [H, W]; first bool 0-d tensor (t == 0).
    Returns (updates, is_bg, lab_bg): new tensors for every table leaf, and
    two bool [H, W] maps."""
    stat_dtype = state["ct_P"].dtype
    f32 = torch.float32
    tabs = {}
    for prefix, key, n1 in (("ct", ckey, cfg.N1c), ("cc", cckey, cfg.N1cc)):
        P, Pb = state[f"{prefix}_P"].to(f32), state[f"{prefix}_Pb"].to(f32)
        tabs[prefix] = (P, Pb, key, _lookup(state[f"{prefix}_key"], P, Pb, key, n1, cfg.T))
    # changed pixels take the co-occurrence table's verdict, the others the
    # colour table's; the first frame is all background
    is_bg = torch.where(changed, tabs["cc"][3][1], tabs["ct"][3][1]) | first
    fg_age = torch.where(is_bg, 0, state["fg_age"] + 1).to(torch.int32)
    lab_bg = is_bg | (fg_age >= cfg.absorbFrames)
    out = {"fg_age": fg_age}
    for prefix, do in (("ct", ~changed | first), ("cc", changed)):
        P, Pb, key, (fi, _, min_idx) = tabs[prefix]
        out[f"{prefix}_key"], out[f"{prefix}_P"], out[f"{prefix}_Pb"] = _update(
            state[f"{prefix}_key"], P, Pb, key, fi, min_idx, do, lab_bg, cfg.alpha2, stat_dtype
        )
    return out, is_bg, lab_bg


def fgd_tables(cfg, state, ckey, cckey, changed, first):
    """Same contract as :func:`fgd_tables_ref`. CPU tensors take the plain
    version. CUDA tensors launch the kernel, which updates the table leaves
    and ``fg_age`` IN PLACE and returns them; ``first`` stays on the card."""
    if changed.device.type == "cpu":
        return fgd_tables_ref(cfg, state, ckey, cckey, changed, first)
    H, W = changed.shape
    C = ckey.shape[0]
    n2c, n2cc = cfg.N2c, cfg.N2cc
    sd = state["ct_P"].dtype
    if sd not in (torch.float16, torch.float32):
        raise ValueError(f"FGD statistics must be float16 or float32, got {sd}")
    if 2 * C > MAX_KEY_BYTES:
        raise ValueError(f"FGD keys of {C} channels: the kernel takes 1 to {MAX_KEY_BYTES // 2}")
    req = _native.require
    req(state["ct_key"], "ct_key", torch.uint8, (n2c, C, H, W))
    req(state["cc_key"], "cc_key", torch.uint8, (n2cc, 2 * C, H, W))
    for prefix, n in (("ct", n2c), ("cc", n2cc)):
        req(state[f"{prefix}_P"], f"{prefix}_P", sd, (n, H, W))
        req(state[f"{prefix}_Pb"], f"{prefix}_Pb", sd, (n, H, W))
    req(state["fg_age"], "fg_age", torch.int32, (H, W))
    req(ckey, "ckey", torch.uint8, (C, H, W))
    req(cckey, "cckey", torch.uint8, (2 * C, H, W))
    req(changed, "changed", torch.bool, (H, W))
    req(first, "first", torch.bool, ())
    masks = torch.empty((2, H, W), dtype=torch.bool, device=changed.device)
    is_bg, lab_bg = masks[0], masks[1]
    leaves = [state[k] for k in TABLE_LEAVES]
    rc = _native.library().tt_fgd_tables(
        *(x.data_ptr() for x in leaves), ckey.data_ptr(), cckey.data_ptr(), changed.data_ptr(),
        first.data_ptr(), is_bg.data_ptr(), lab_bg.data_ptr(),
        H, W, C, n2c, n2cc, cfg.N1c, cfg.N1cc, cfg.absorbFrames, int(sd == torch.float16),
        cfg.T, 1.0 - cfg.alpha2, cfg.alpha2, _native.stream_ptr(),
    )
    _native.check(rc, "fgd_tables")
    _native.count_launch("fgd_tables")
    return {k: state[k] for k in TABLE_LEAVES}, is_bg, lab_bg
