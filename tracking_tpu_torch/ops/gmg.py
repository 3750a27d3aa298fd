"""GMG's per-pixel list update: the CUDA kernel ``gmg_step``
(``csrc/gmg.cu``, replacing ``tracking_tpu/ops/pallas_gmg.py:gmg_step_pallas``)
and its plain version ``gmg_step_ref`` (the XLA branch of
``tracking_tpu/bgs/gmg.py:GMG.step``).

Each pixel keeps a move-to-front list of K quantised colour codes with
weights. Per frame, in order: find the frame's code in the list; the
Bayes foreground decision from the matched weight; decay every weight (not
while training); move the match to the front, or evict the last entry of a
full list, or append; normalise when the list grew or training ends.

Colours travel as int32 (the u32 state viewed as int32, where the empty
sentinel 0xFFFFFFFF is −1): torch's uint32 has only a few operators. The
normalisation sum ``total`` is a sum of floats whose order changes its last
bits (``pallas_gmg.py:15-19``): the plain version and the kernel both take
XLA:CPU's order (:func:`blocked_sum`), so the port agrees exactly with the
reference on the CPU and the kernel with its plain version on the card.
"""

from __future__ import annotations

import torch

from tracking_tpu_torch.ops import _native

# XLA:CPU splits a reduction over more than 32 elements into runs of 32
# (its tree-reduction rewrite): the partial sums of 32 terms each, in index
# order, are then added in order
SUM_BLOCK = 32


def _consts(lr: float, prior: float):
    """The reference's Python-double constants, as JAX rounds them to f32."""
    return dict(lr=lr, oml=1.0 - lr, prior=prior, omp=1.0 - prior)


def blocked_sum(terms, block: int = SUM_BLOCK):
    """Σ terms in XLA:CPU's order for a reduction over a long axis: each run
    of ``block`` terms summed in index order, then the partial sums in
    order. The kernel sums the same way."""
    total = None
    for s in range(0, len(terms), block):
        part = terms[s]
        for x in terms[s + 1 : s + block]:
            part = part + x
        total = part if total is None else total + part
    return total


def gmg_step_ref(code, nf, colors, weights, t, *, lr: float, prior: float, thr: float, init_frames: int):
    """Plain torch. code int32 [H, W]; nf int32 [H, W]; colors int32
    [K, H, W] (sentinel −1); weights f32 [K, H, W]; t int32 0-d. Returns
    (fg_raw int32 0/255 before the median, nf1, colors, weights), new
    tensors."""
    K = colors.shape[0]
    k = _consts(lr, prior)
    f32 = torch.float32
    kidx = torch.arange(K, dtype=torch.int32, device=code.device)[:, None, None]
    training = t < init_frames
    end_train = t == init_frames - 1

    found = (colors == code[None]) & (nf[None] > kidx)
    fi = torch.where(found, kidx, K).amin(dim=0)  # first find (K where none)
    has = fi < K
    fi_c = fi.clamp(max=K - 1).long()[None]
    # the reference's sums over k of one-hot masked terms are the picked
    # value exactly (every other term is +0)
    w_match = torch.where(has, weights.gather(0, fi_c)[0], 0.0)
    post = (w_match * k["prior"]) / (w_match * k["prior"] + (1.0 - w_match) * k["omp"])
    is_fg = ~training & ((1.0 - post) > thr)

    insert_w = torch.where(training, torch.ones((), dtype=f32, device=code.device), torch.full((), k["lr"], dtype=f32, device=code.device))
    dec = torch.where(training, weights, weights * k["oml"])
    front_w = insert_w + torch.where(has, dec.gather(0, fi_c)[0], 0.0)
    full = nf >= K
    use_front = has | full
    appended = ~use_front
    row0 = kidx == 0
    prev_c = torch.cat([colors[:1], colors[:-1]])
    prev_w = torch.cat([dec[:1], dec[:-1]])
    shift = torch.where(row0, use_front[None], (has[None] & (kidx <= fi[None])) | (~has & full)[None])
    new_colors = torch.where(shift, torch.where(row0, code[None], prev_c), colors)
    new_weights = torch.where(shift, torch.where(row0, front_w[None], prev_w), dec)
    at_append = appended[None] & (nf[None] == kidx)
    new_colors = torch.where(at_append, code[None], new_colors)
    new_weights = torch.where(at_append, front_w[None], new_weights)
    nf1 = nf + appended.to(torch.int32)

    do_norm = (appended & ~training) | end_train
    total = blocked_sum([torch.where(nf1 > j, new_weights[j], 0.0) for j in range(K)])
    new_weights = torch.where(do_norm[None], new_weights / torch.clamp(total, min=1e-20)[None], new_weights)
    fg = torch.where(is_fg, 255, 0).to(torch.int32)
    return fg, nf1, new_colors, new_weights


def gmg_step(code, nf, colors, weights, t, *, lr: float, prior: float, thr: float, init_frames: int):
    """Same contract as :func:`gmg_step_ref`. CPU tensors take the plain
    version. CUDA tensors launch the kernel, which updates ``colors`` and
    ``weights`` IN PLACE and returns them; ``t`` stays on the card."""
    kw = dict(lr=lr, prior=prior, thr=thr, init_frames=init_frames)
    if code.device.type == "cpu":
        return gmg_step_ref(code, nf, colors, weights, t, **kw)
    K, H, W = colors.shape
    req = _native.require
    req(code, "code", torch.int32, (H, W))
    req(nf, "nf", torch.int32, (H, W))
    req(colors, "colors", torch.int32, (K, H, W))
    req(weights, "weights", torch.float32, (K, H, W))
    req(t, "t", torch.int32, ())
    k = _consts(lr, prior)
    out = torch.empty((2, H, W), dtype=torch.int32, device=code.device)
    fg, nf1 = out[0], out[1]
    rc = _native.library().tt_gmg_step(
        code.data_ptr(), nf.data_ptr(), colors.data_ptr(), weights.data_ptr(), t.data_ptr(),
        fg.data_ptr(), nf1.data_ptr(), K, H, W,
        k["lr"], k["oml"], k["prior"], k["omp"], thr, init_frames, _native.stream_ptr(),
    )
    _native.check(rc, "gmg_step")
    _native.count_launch("gmg_step")
    return fg, nf1, colors, weights
