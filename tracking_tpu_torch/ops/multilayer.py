"""MultiLayerBGS's per-pixel frame update: the CUDA kernel
``multilayer_step`` (``csrc/multilayer.cu``, replacing
``tracking_tpu/ops/pallas_multilayer.py:multilayer_step_pallas``) and its
plain version :func:`ml_update_ref` (``tracking_tpu/bgs/multilayer.py:
_ml_update``, statement by statement).

Per pixel, with ≤ M = 5 modes kept weight-sorted: drop one faded layered
mode; per mode the texture distance (share of the L = 6 LBP pattern values
that moved) and the colour distance (out of the shadow/highlight range, or
the noise-corrected angle); the best mode; then one of three branches -
seed an empty list, decay all and append (no match), or blend the best mode
and decay the others (match) - with the layer bookkeeping; the removal of
displaced layers; the weight sort and the background-mode count ``bg_num``.

Floats follow the reference's order of operations: sums over the colour
axis are written out in order, the mean over the pattern axis is a sum
times ``recip(6)`` (XLA's rewrite of a division by a constant), true
divisions take tensor divisors, and ``1 − lr`` arrives precomputed
(``oml``) as the reference forms it, and the colour distance's ``exp``
and ``sqrt`` are XLA:CPU's (``ops/xla_math``: its Cephes ``exp`` with the
multiply-adds its compiled code contracts, and the correctly rounded
root; torch's CPU ``exp`` and ``sqrt`` differ from them in the last bit
on some arguments). So this version equals the JAX package bit for bit on
the CPU, and the kernel equals it on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from tracking_tpu_torch.ops import _native, xla_math
from tracking_tpu_torch.ops.consensus import recip
from tracking_tpu_torch.ops.sort import sort_desc_maps

PI = 3.141592653589793
INF = float("inf")

# per-mode state leaves and their short names in the update's A dict; bi,
# mini, maxi and bp carry a feature axis ([C] or [L]) under the mode axis
LEAF_SPEC = (
    ("weight", "w"),
    ("max_weight", "mw"),
    ("bg_int", "bi"),
    ("min_int", "mini"),
    ("max_int", "maxi"),
    ("bg_pattern", "bp"),
    ("bg_layer", "layer"),
    ("layer_time", "layt"),
    ("first_time", "ft"),
    ("last_time", "lt"),
    ("freq", "fq"),
)


def _sum0(x: torch.Tensor) -> torch.Tensor:
    """Σ over the leading axis in index order (XLA's order for a short
    reduction; torch's own reduction may pair terms otherwise on the card)."""
    out = x[0]
    for i in range(1, x.shape[0]):
        out = out + x[i]
    return out


def bg_num_of(cfg, ws, n_act):
    """Smallest prefix of the sorted active weights holding more than
    ``bg_mode_percent`` of their total (CMultiLayerBGS.cpp:727-748)."""
    M = len(ws)
    aw = [torch.where(n_act > m, ws[m], 0.0) for m in range(M)]
    tot = aw[0]
    for m in range(1, M):
        tot = tot + aw[m]
    cum = torch.zeros_like(tot)
    out = torch.zeros(tot.shape, dtype=torch.int32, device=tot.device)
    found = torch.zeros(tot.shape, dtype=torch.bool, device=tot.device)
    for m in range(M):
        cum = cum + aw[m]
        over = cum > cfg.bg_mode_percent * tot
        out = torch.where(~found & over, m + 1, out)
        found = found | over
    return out


def _sel(idx, maps):
    """maps[idx[p]] per pixel."""
    out = maps[0]
    for m in range(1, len(maps)):
        out = torch.where(idx == m, maps[m], out)
    return out


def joint_distances(cfg, A, n, cf, cur_pat):
    """Per mode the joint texture+colour distance, ``inf`` for inactive
    modes (``multilayer.py:371-405``). Returns a list of M [H, W] maps."""
    M = cfg.max_mode_num
    dev = n.device
    f32 = torch.float32
    lbp_thr = 1.0 - cfg.min_lbp_binary_prob
    offset = torch.full((), max(cfg.robust_LBP_constant, 5.0), dtype=f32, device=dev)
    min_sine = float(np.sin(cfg.min_noised_angle))
    n2c = _sum0(cf * cf)
    joints = []
    for m in range(M):
        tex_d = _sum0(((cur_pat - A["bp"][m]).abs() > lbp_thr).to(f32)) * recip(cur_pat.shape[0])
        bi = A["bi"][m]
        lo = torch.minimum(A["mini"][m], bi * cfg.shadow_rate - 5.0)
        hi = torch.maximum(A["maxi"][m], bi * cfg.highlight_rate + 5.0)
        out_range = ((cf > hi) | (cf < lo)).any(dim=0)
        dot = _sum0(bi * cf)
        n1 = _sum0(bi * bi)
        n12 = n1 * n2c
        sin2 = torch.clamp(1.0 - dot * dot / torch.clamp(n12, min=1e-20), min=0.0)
        org_angle = torch.where(n12 == 0, 0.0, xla_math.sqrt(sin2))
        norm_bg = xla_math.sqrt(n1)
        sin_noise = offset / torch.clamp(norm_bg, min=1e-20)
        noised = torch.where(
            norm_bg == 0, PI,
            torch.where(sin_noise < min_sine, cfg.min_noised_angle, torch.where(sin_noise >= 1.0, PI, sin_noise)),
        )
        angle = torch.clamp(org_angle - noised, min=0.0)
        col_d = torch.where(out_range, 1.0, 1.0 - xla_math.exp(-100.0 * angle * angle))
        joint = cfg.texture_weight * tex_d + (1.0 - cfg.texture_weight) * col_d
        joints.append(torch.where(n > m, joint, INF))
    return joints


def ml_update_ref(cfg, A, n, bg_num, cf, cur_pat, scal, frame_idx, learn: bool):
    """Plain torch ``_ml_update``. ``A`` maps the short leaf names to lists
    of M per-mode maps ([H, W], or [C|L, H, W] for bi, mini, maxi, bp); n, bg_num
    int32 [H, W]; cf f32 [C, H, W]; cur_pat f32 [L, H, W]; ``scal`` f32 [4]
    = (lr, wlr, imw, 1 − lr); frame_idx int32 0-d. Returns (A, n, bg_num,
    out_dist), new tensors."""
    M = cfg.max_mode_num
    wuc = cfg.weight_updating_constant
    lr, wlr, imw, oml = scal.unbind(0)
    dev = n.device
    i32 = torch.int32
    A = {k: list(v) for k, v in A.items()}

    # -- RemoveBackgroundLayers, single removal --------------------------------
    changed1 = torch.zeros(n.shape, dtype=torch.bool, device=dev)
    if learn:
        r = torch.full(n.shape, M, dtype=i32, device=dev)
        for m in reversed(range(M)):
            rem = (A["layer"][m] > 0) & (A["w"][m] < cfg.min_bg_layer_weight) & (n > m)
            r = torch.where(rem, m, r)
        changed1 = r < M
        rl = _sel(torch.clamp(r, max=M - 1), A["layer"])
        for k in A:
            old = A[k]
            A[k] = [torch.where(changed1 & (r <= m), old[m + 1], old[m]) for m in range(M - 1)] + [old[M - 1]]
        dec_on = changed1 & (rl > 0)
        A["layer"] = [torch.where(dec_on & (lay > rl), lay - 1, lay) for lay in A["layer"]]
        n = n - changed1.to(i32)
        bg_num = torch.where(changed1, bg_num_of(cfg, A["w"], n), bg_num)

    active = [n > m for m in range(M)]
    is_empty = n == 0

    # -- distances and the best mode ------------------------------------------
    joints = joint_distances(cfg, A, n, cf, cur_pat)
    best_d = torch.full(n.shape, INF, dtype=torch.float32, device=dev)
    best = torch.zeros(n.shape, dtype=i32, device=dev)
    for m in range(M):
        best = torch.where(joints[m] < best_d, m, best)
        best_d = torch.minimum(best_d, joints[m])
    updating = best_d < cfg.bg_prob_updating_threshold
    penal = (best >= bg_num) & (_sel(best, A["mw"]) < cfg.reliable_bg_mode_weight)
    out_dist = torch.where(penal, torch.clamp(best_d, min=cfg.bg_prob_threshold * 2.5), best_d)
    do_match = ~is_empty & updating & learn
    do_nomatch = ~is_empty & ~updating & learn

    # -- seed (empty list) -----------------------------------------------------
    S = {k: list(v) for k, v in A.items()}
    ones = torch.ones(n.shape, dtype=torch.float32, device=dev)
    S["w"][0] = ones * imw
    S["mw"][0] = ones * imw
    S["bi"][0] = S["mini"][0] = S["maxi"][0] = cf
    S["bp"][0] = cur_pat
    S["layer"][0] = torch.zeros(n.shape, dtype=i32, device=dev)
    S["ft"][0] = S["lt"][0] = torch.full(n.shape, 0, dtype=i32, device=dev) + frame_idx
    S["fq"][0] = torch.ones(n.shape, dtype=i32, device=dev)

    # -- no match: decay the active modes, append or overwrite the tail -------
    NM = {k: list(v) for k, v in A.items()}
    slot_app = torch.clamp(n, max=M - 1)
    for m in range(M):
        decay = 1.0 - wlr / (1.0 + wuc * NM["mw"][m])
        wdec = torch.where(active[m], NM["w"][m] * decay, NM["w"][m])
        at = slot_app == m
        NM["w"][m] = torch.where(at, imw, wdec)
        NM["mw"][m] = torch.where(at, imw, NM["mw"][m])
        for k, src in (("bi", cf), ("mini", cf), ("maxi", cf), ("bp", cur_pat)):
            NM[k][m] = torch.where(at, src, NM[k][m])
        NM["layer"][m] = torch.where(at, 0, NM["layer"][m])
        NM["layt"][m] = torch.where(at, -1, NM["layt"][m])
        NM["ft"][m] = torch.where(at, frame_idx, NM["ft"][m])
        NM["lt"][m] = torch.where(at, frame_idx, NM["lt"][m])
        NM["fq"][m] = torch.where(at, 1, NM["fq"][m])

    # -- match: blend the best mode, layer bookkeeping, decay the others ------
    MT = {k: list(v) for k, v in A.items()}
    for m in range(M):
        at = best == m
        MT["ft"][m] = torch.where(at, torch.clamp(torch.minimum(MT["ft"][m], frame_idx), min=0), MT["ft"][m])
        MT["lt"][m] = torch.where(at, frame_idx, MT["lt"][m])
        MT["fq"][m] = torch.where(at, MT["fq"][m] + 1, MT["fq"][m])
        MT["bi"][m] = torch.where(at, oml * MT["bi"][m] + lr * cf, MT["bi"][m])
        MT["mini"][m] = torch.where(at, torch.minimum(MT["mini"][m], cf), MT["mini"][m])
        MT["maxi"][m] = torch.where(at, torch.maximum(MT["maxi"][m], cf), MT["maxi"][m])
        MT["bp"][m] = torch.where(at, oml * MT["bp"][m] + lr * cur_pat, MT["bp"][m])
        inc = wlr * (1.0 + wuc * MT["mw"][m])
        MT["w"][m] = torch.where(at, (1.0 - inc) * MT["w"][m] + inc, MT["w"][m])
        MT["mw"][m] = torch.where(at, torch.maximum(MT["w"][m], MT["mw"][m]), MT["mw"][m])
    b_layer, b_w, b_mw = _sel(best, MT["layer"]), _sel(best, MT["w"]), _sel(best, MT["mw"])
    displaced = [
        (b_layer > 0) & (b_w > b_mw * 0.2) & (MT["layer"][m] > b_layer) & (MT["w"][m] < MT["mw"][m] * 0.9) & active[m]
        for m in range(M)
    ]
    promote = (b_layer == 0) & (b_mw > cfg.reliable_bg_mode_weight)
    max_layer = torch.zeros(n.shape, dtype=i32, device=dev)
    for m in range(M):
        max_layer = torch.maximum(max_layer, torch.where(active[m], MT["layer"][m], 0))
    for m in range(M):
        at = best == m
        MT["layer"][m] = torch.where(at & promote, max_layer + 1, MT["layer"][m])
        MT["layt"][m] = torch.where(at & promote, frame_idx, MT["layt"][m])
        decay = 1.0 - wlr / (1.0 + wuc * MT["mw"][m])
        MT["w"][m] = torch.where(active[m] & ~at, MT["w"][m] * decay, MT["w"][m])

    for k in A:
        A[k] = [
            torch.where(do_match, MT[k][m], torch.where(do_nomatch, NM[k][m], torch.where(is_empty, S[k][m], A[k][m])))
            for m in range(M)
        ]
    n = torch.where(is_empty, 1, torch.where(do_nomatch, torch.clamp(n + 1, max=M), n)).to(i32)
    bg_num = torch.where(is_empty, 1, bg_num).to(i32)

    # -- displaced-layer removal, weight sort, bg_num --------------------------
    if learn:
        rem4 = [displaced[m] & do_match for m in range(M)]
        keep = [~rem4[m] & (n > m) for m in range(M)]
        layer_old = list(A["layer"])
        A["layer"] = [
            layer_old[m] - sum(
                (rem4[k2] & (layer_old[k2] > 0) & (layer_old[m] > layer_old[k2])).to(i32) for k2 in range(M)
            )
            for m in range(M)
        ]
        kc, run = [], torch.zeros(n.shape, dtype=i32, device=dev)
        for m in range(M):
            run = run + keep[m].to(i32)
            kc.append(run - 1)
        for k in A:
            old = A[k]
            newl = []
            for m in range(M):
                v = old[m]
                for j in range(M):
                    v = torch.where(keep[j] & (kc[j] == m), old[j], v)
                newl.append(v)
            A[k] = newl
        n_rem = sum(rem4[m].to(i32) for m in range(M))
        changed4 = n_rem > 0
        n = n - n_rem
        key = [torch.where(n > m, A["w"][m], -INF) for m in range(M)]
        names = list(A)
        _, payloads = sort_desc_maps(key, [A[k] for k in names])
        A = dict(zip(names, payloads))
        gate = ((n > 1) & ~is_empty) | changed1 | changed4 | is_empty
        bg_num = torch.where(gate, bg_num_of(cfg, A["w"], n), bg_num)

    out_dist = torch.where(is_empty, 0.0, out_dist)
    return A, n, bg_num, out_dist


def _kernel_consts(cfg):
    """The kernel's ``Consts``, the derived ones formed in double as in
    :func:`joint_distances` and :func:`ml_update_ref`."""
    return (
        cfg.weight_updating_constant, cfg.bg_mode_percent, cfg.min_bg_layer_weight,
        1.0 - cfg.min_lbp_binary_prob, max(cfg.robust_LBP_constant, 5.0), float(np.sin(cfg.min_noised_angle)),
        cfg.min_noised_angle, cfg.shadow_rate, cfg.highlight_rate, cfg.texture_weight, 1.0 - cfg.texture_weight,
        cfg.bg_prob_updating_threshold, cfg.bg_prob_threshold * 2.5, cfg.reliable_bg_mode_weight,
    )


def update_branches(cfg, state, cf, cur_pat, scal, n_out, learn: bool):
    """Which branch of the update each pixel of ``state`` took, as boolean
    [H, W] maps, given the update's new ``n`` (``n_out``): ``removal`` (a
    faded layered mode dropped; ``removal_empties`` where that emptied the
    list) and, on the other pixels, ``match`` (with ``promote`` and
    ``displacement``), ``append`` and ``overwrite`` (no match, n < M and n =
    M) and ``empty`` (the seed). For tests and on-card checks."""
    M = cfg.max_mode_num
    n = state["n"]
    removal = torch.zeros(n.shape, dtype=torch.bool, device=n.device)
    if learn:
        for m in range(M):
            removal |= (state["bg_layer"][m] > 0) & (state["weight"][m] < cfg.min_bg_layer_weight) & (n > m)
    A = {short: list(state[leaf].unbind(0)) for leaf, short in LEAF_SPEC}
    best_d, best = torch.stack(joint_distances(cfg, A, n, cf, cur_pat)).min(dim=0)
    rest = ~removal & (n > 0)
    match = rest & (best_d < cfg.bg_prob_updating_threshold) & learn
    nomatch = rest & ~match & learn

    def at_best(leaf):
        return state[leaf].gather(0, best[None])[0]

    inc = scal[1] * (1.0 + cfg.weight_updating_constant * at_best("max_weight"))
    mw = torch.maximum((1.0 - inc) * at_best("weight") + inc, at_best("max_weight"))
    return {
        "removal": removal,
        "removal_empties": removal & (n == 1),
        "match": match,
        "promote": match & (at_best("bg_layer") == 0) & (mw > cfg.reliable_bg_mode_weight),
        "displacement": match & (n_out < n),
        "append": nomatch & (n < M),
        "overwrite": nomatch & (n == M),
        "empty": ~removal & (n == 0),
    }


def multilayer_step_ref(cfg, state, cf, cur_pat, scal, frame_idx, learn: bool):
    """:func:`ml_update_ref` on a MultiLayer state: returns (a dict of the
    new ``n``, ``bg_num`` and mode leaves, out_dist f32 [H, W])."""
    A = {short: list(state[leaf].unbind(0)) for leaf, short in LEAF_SPEC}
    A, n, bg_num, dist = ml_update_ref(cfg, A, state["n"], state["bg_num"], cf, cur_pat, scal, frame_idx, learn)
    maps = {"n": n, "bg_num": bg_num}
    for leaf, short in LEAF_SPEC:
        maps[leaf] = torch.stack(A[short])
    return maps, dist


def multilayer_step(cfg, state, cf, cur_pat, scal, frame_idx, learn: bool):
    """Same contract as :func:`multilayer_step_ref`. CPU tensors take the
    plain version. CUDA tensors launch the kernel, which updates the mode
    leaves, ``n`` and ``bg_num`` IN PLACE and returns them."""
    if cf.device.type == "cpu":
        return multilayer_step_ref(cfg, state, cf, cur_pat, scal, frame_idx, learn)
    M = cfg.max_mode_num
    C, H, W = cf.shape
    L = cur_pat.shape[0]
    if M != 5 or C != 3 or L != 6:
        raise ValueError(f"the multilayer kernel is built for 5 modes, 3 colours and 6 pattern values, got {M}, {C}, {L}")
    req = _native.require
    req(cf, "cf", torch.float32, (C, H, W))
    req(cur_pat, "cur_pat", torch.float32, (L, H, W))
    req(scal, "scal", torch.float32, (4,))
    req(frame_idx, "frame_idx", torch.int32, ())
    req(state["n"], "n", torch.int32, (H, W))
    req(state["bg_num"], "bg_num", torch.int32, (H, W))
    for leaf, short in LEAF_SPEC:
        lead = {"bi": C, "mini": C, "maxi": C, "bp": L}.get(short)
        shape = (M, lead, H, W) if lead else (M, H, W)
        dtype = torch.float32 if short in ("w", "mw") or lead else torch.int32
        req(state[leaf], leaf, dtype, shape)
    dist = torch.empty((H, W), dtype=torch.float32, device=cf.device)
    rc = _native.library().tt_multilayer_step(
        state["n"].data_ptr(), state["bg_num"].data_ptr(),
        *(state[leaf].data_ptr() for leaf, _ in LEAF_SPEC),
        cf.data_ptr(), cur_pat.data_ptr(), scal.data_ptr(), frame_idx.data_ptr(), dist.data_ptr(),
        H, W, int(learn), *_kernel_consts(cfg), _native.stream_ptr(),
    )
    _native.check(rc, "multilayer_step")
    _native.count_launch("multilayer_step")
    maps = {"n": state["n"], "bg_num": state["bg_num"]}
    for leaf, _ in LEAF_SPEC:
        maps[leaf] = state[leaf]
    return maps, dist
