"""Single-stream row sharding with explicit halos, counterpart of
``tracking_tpu/parallel/spatial.py``.

Each rank of a mesh's ``space`` axis (threads of a
:class:`~tracking_tpu_torch.parallel.mesh.ShardGroup`, or processes of a
``parallel/dist.py`` group, one a device) owns ``h_loc = H / n`` rows of
every frame and of every per-pixel state leaf.
Bounded stencils read halo-extended slabs whose halo rows come from the
neighbours (``ppermute``) and whose rows outside the image carry the op's
border semantics, so the op itself runs unchanged; the unbounded ops - the
hole fill's reachability and CC labelling - run per-rank fixed points with
boundary-row injection rounds until a summed flag says nothing changed.
RNG fields are drawn at the global shape and row-sliced, so every pixel
sees the unsharded run's draw. Masks, blob tables, tracks and states are
bit-identical to the unsharded path.

On CUDA tensors the per-rank work launches the port's kernels: the
consensus in slab mode (``ops/consensus.consensus(..., row_ext=)``), the
reachability (``flood_reach``), the min-label fixed point
(``label_fixpoint``) and, in the replicated tracker, ``greedy_assign``.
``use_kernels=False`` takes their plain versions. Row indices are Python
integers here (a rank knows its rows), where the JAX version traces them.

Entry points: :func:`run_video_spatial` (one stream of SuBSENSE - v1, v3,
or v1 under ``TRACKING_TPU_FUSED=1`` as in the JAX package - or LOBSTER),
:func:`run_video_spatial_tracked` (SuBSENSE followed by the CC / CCMSPF
tracker), both over ``n_shards`` threads or a ``mesh``'s ``space`` axis
(its other rows replicate the stream, as JAX's ``shard_map`` does), and
:func:`run_video_batch_spatial` (streams × row shards on a ``Mesh``, each
stream row a ``space`` view of the 2-D group that synchronises only with
itself: ``parallel/mesh.py``). ``parallel/mesh.py:run_video_batch`` routes
to the last. A state the call makes is made and warm-started unsharded
on each rank (its first frame gathered over the row's ranks), which keeps
its own rows (:func:`shard_state`'s part); a rank receives only its own
rows of the frames. States come back joined (:func:`gather_state`) where
every input is a tensor, else placed on the ranks (``parallel/placed.py``).
The per-rank functions are module-level, so a process mesh can send
them.

The unbounded loops (:func:`sharded_fill`, :func:`sharded_label`) stop
when their row's summed change flag is 0. The JAX package sums that flag
over both mesh axes (``conv_axes``) to keep XLA:CPU's in-process
rendezvous in step, so there a converged row runs the other rows' extra
rounds; each such round only re-confirms its fixed point (the boundary
rows injected are the ones it converged on), so a row that stops on its
own count gives the same bits.
"""

from __future__ import annotations

import inspect
from typing import Optional, Sequence

import torch

from tracking_tpu_torch.convert import split_states, stack_states
from tracking_tpu_torch.ops.consensus import slab_shift
from tracking_tpu_torch.parallel.mesh import Mesh, ShardComm, batch_dims, batch_state_meta, run_streams
from tracking_tpu_torch.parallel.placed import (Leaf, MeshArray, block_of, join, map_tensors, meta_leaf, meta_of, owned,
                                                placed_mesh, rank_args)

HALO = 8  # the frame slabs' halo rows: LBSP ±2, spread ±2, refresh pattern ±3 (+ slack)
N_CAND = 128  # blob-root candidates a frame (the sharded table is exact up to this many components)


class SpatialCtx:
    """One rank's view of a row-sharded frame of global height ``h_global``."""

    def __init__(self, comm: ShardComm, h_global: int, device=None):
        if h_global % comm.n:
            raise ValueError(f"height {h_global} does not split into {comm.n} shards")
        if HALO > h_global:
            raise ValueError("the halo exceeds the global height")
        self.comm = comm
        self.n = comm.n
        self.idx = comm.rank
        self.H = h_global
        self.halo = HALO
        self.h_loc = h_global // comm.n
        self.row0 = self.idx * self.h_loc
        self.device = device

    # -- collectives ---------------------------------------------------------
    def _ppermute(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        return self.comm.ppermute(x, shift)

    def _halo_band(self, x: torch.Tensor, hl: int, top: bool) -> torch.Tensor:
        """The ``hl`` rows directly above (``top``) or below this slab,
        gathered from as many neighbours as the band spans (several hops
        when ``hl > h_loc``); rows outside the image arrive zero-filled."""
        hops = -(-hl // self.h_loc)
        r = hl - (hops - 1) * self.h_loc  # rows taken from the farthest hop
        parts = []
        for k in range(hops, 0, -1):
            band = (x[..., -r:, :] if top else x[..., :r, :]) if k == hops else x
            parts.append(self._ppermute(band, +k if top else -k))
        return torch.cat(parts if top else parts[::-1], dim=-2)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.psum(x)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.pmax(x)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Owned [..., h_loc, W] -> the full [..., H, W] on every rank."""
        return self.comm.all_gather(x, dim=x.ndim - 2)

    def own_rows(self, x_full: torch.Tensor) -> torch.Tensor:
        """Full [..., H, W] -> this rank's owned rows."""
        return x_full.narrow(x_full.ndim - 2, self.row0, self.h_loc)

    rng_rows = own_rows  # a global-shape random field, row-sliced

    # -- halo construction -----------------------------------------------------
    def out_globe(self, halo: int, rows: int):
        """(top, bottom): how many rows at each end of a ``rows``-row slab
        with ``halo`` rows above the owned ones lie outside the image."""
        first = self.row0 - halo
        return max(0, -first), max(0, first + rows - self.H)

    def _clamp(self, ext: torch.Tensor, halo: int, lo: int, hi: int) -> torch.Tensor:
        """Rows of ``ext`` (first row global ``row0 − halo``) above global
        row ``lo`` / below ``hi`` replaced by rows ``lo`` / ``hi``."""
        first, eh = self.row0 - halo, ext.shape[-2]
        n_top, n_bot = max(0, lo - first), max(0, first + eh - 1 - hi)
        if n_top == 0 and n_bot == 0:
            return ext
        size = list(ext.shape)
        parts = []
        if n_top:
            size[-2] = n_top
            parts.append(ext[..., n_top : n_top + 1, :].expand(size))
        parts.append(ext[..., n_top : eh - n_bot, :])
        if n_bot:
            size[-2] = n_bot
            parts.append(ext[..., eh - n_bot - 1 : eh - n_bot, :].expand(size))
        return torch.cat(parts, dim=-2)

    def _extend(self, x: torch.Tensor, hl: int) -> torch.Tensor:
        return torch.cat([self._halo_band(x, hl, True), x, self._halo_band(x, hl, False)], dim=-2)

    def extend_plain(self, x: torch.Tensor, halo: Optional[int] = None) -> torch.Tensor:
        """[..., h_loc, W] -> [..., h_loc + 2·halo, W] whose row y holds
        ``global[clip(row0 − halo + y, 0, H − 1)]`` (edge clamp)."""
        hl = self.halo if halo is None else halo
        return self._clamp(self._extend(x, hl), hl, 0, self.H - 1)

    def extend_border(self, x: torch.Tensor, border: int = 2, halo: Optional[int] = None) -> torch.Tensor:
        """Like :meth:`extend_plain` with the LBSP-ROI clamp
        ``clip(·, border, H − 1 − border)`` in the contents."""
        hl = self.halo if halo is None else halo
        return self._clamp(self._extend(x, hl), hl, border, self.H - 1 - border)

    def extend_const(self, x: torch.Tensor, halo: int, const=0) -> torch.Tensor:
        """Like :meth:`extend_plain` with ``const`` in the rows outside the
        image (OpenCV's constant morphology border: erode 255, dilate 0)."""
        return self.fill_out_globe(self._extend(x, halo), halo, const)

    def fill_out_globe(self, slab: torch.Tensor, halo: int, value) -> torch.Tensor:
        """``slab`` with its rows outside the image set to ``value`` (a new
        tensor where any row changes)."""
        n_top, n_bot = self.out_globe(halo, slab.shape[-2])
        if n_top == 0 and n_bot == 0:
            return slab
        out = slab.clone()
        if n_top:
            out[..., :n_top, :] = value
        if n_bot:
            out[..., out.shape[-2] - n_bot :, :] = value
        return out

    def clamp_rows(self, ext: torch.Tensor, halo: int) -> torch.Tensor:
        """A slab's rows outside the image overwritten by the edge rows 0 /
        H − 1: edge replication of values computed on the slab."""
        return self._clamp(ext, halo, 0, self.H - 1)

    def crop(self, ext: torch.Tensor, halo: Optional[int] = None) -> torch.Tensor:
        """Extended slab -> owned rows."""
        hl = self.halo if halo is None else halo
        return ext[..., hl : hl + self.h_loc, :]

    def shift_ext(self, ext_border: torch.Tensor, dy: int, dx: int, border: int = 2) -> torch.Tensor:
        """``shift_clamped`` on a border-extended slab: owned-shape
        S(y, x) = global[clip(y − dy, b, H−1−b), clip(x − dx, b, W−1−b)]."""
        return slab_shift(ext_border, self.halo, dy, dx, border)

    def roi(self, w: int, border: int = 2) -> torch.Tensor:
        """Owned rows of the global LBSP ROI (the 2-px border outside)."""
        out = torch.zeros((self.h_loc, w), dtype=torch.bool, device=self.device)
        y_lo = max(border - self.row0, 0)
        y_hi = min(self.H - border - self.row0, self.h_loc)
        if y_hi > y_lo:
            out[y_lo:y_hi, border : w - border] = True
        return out


def _flag(ctx: SpatialCtx, local_change: torch.Tensor) -> bool:
    """The ranks' change flags summed in rank order: any rank changed."""
    return bool(ctx.psum(local_change.to(torch.int32)) > 0)


def sharded_fill(ctx: SpatialCtx, mask_own: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
    """Row-sharded hole filling, exact vs ``ops.morphology.fill_holes(mask,
    seed="corner")``: each round runs the rank's reachability fixed point,
    then takes one boundary row from each neighbour (4-connectivity crosses
    a row cut in the same column only), until no rank changes."""
    from tracking_tpu_torch.ops.morphology import reach_fixpoint

    fg = mask_own > 0
    bg = ~fg
    reach = torch.zeros_like(bg)
    if ctx.row0 == 0:
        reach[0, 0] = bg[0, 0]
    while True:
        reach = reach_fixpoint(bg, reach, use_kernels=use_kernels)
        up = ctx._ppermute(reach[-1:], +1)  # the previous rank's last row
        dn = ctx._ppermute(reach[:1], -1)  # the next rank's first row
        row0_new = reach[:1] | (bg[:1] & up)
        rowl_new = reach[-1:] | (bg[-1:] & dn)
        new = torch.cat([row0_new, reach[1:-1], rowl_new], dim=0)
        changed = _flag(ctx, (new != reach).any())
        reach = new
        if not changed:
            break
    return torch.where(fg | ~reach, 255, 0).to(torch.uint8)


def inject_row(row_lab: torch.Tensor, nb_row: torch.Tensor, big: int, connectivity: int = 8) -> torch.Tensor:
    """An edge row of labels [1, W] (``big`` on background) min-coupled with
    the neighbour's boundary row [1, W] across the cut: the label below or
    above and, 8-connected, its two diagonal neighbours."""
    cand = nb_row
    if connectivity == 8:
        pad = torch.full((1, 1), big, dtype=nb_row.dtype, device=nb_row.device)
        left = torch.cat([pad, nb_row[:, :-1]], dim=1)
        right = torch.cat([nb_row[:, 1:], pad], dim=1)
        cand = torch.minimum(cand, torch.minimum(left, right))
    return torch.where(row_lab < big, torch.minimum(row_lab, cand), big)


def sharded_label(
    ctx: SpatialCtx, mask_own: torch.Tensor, connectivity: int = 8, use_kernels: bool = True
) -> torch.Tensor:
    """Row-sharded CC labelling, exact vs ``ops.cc.label_components``
    (labels are global row-major indices of each component's minimum
    pixel, −1 on background): per-rank min-label fixed points
    (``ops.cc.label_fixpoint``), then one boundary-row exchange with each
    neighbour, coupled with the connectivity's ±1 columns, until no rank
    changes."""
    from tracking_tpu_torch.ops.cc import label_fixpoint

    fg = mask_own > 0
    h, w = mask_own.shape
    big = ctx.H * w
    iota = ctx.row0 * w + torch.arange(h * w, dtype=torch.int32, device=mask_own.device).reshape(h, w)
    lab = torch.where(fg, iota, big).to(torch.int32)


    while True:
        lab, conv = label_fixpoint(fg, lab, big, connectivity, use_kernels=use_kernels)
        up = ctx._ppermute(lab[-1:], +1)
        dn = ctx._ppermute(lab[:1], -1)
        row0_new = inject_row(lab[:1], up, big, connectivity) if ctx.idx > 0 else lab[:1]
        rowl_new = inject_row(lab[-1:], dn, big, connectivity) if ctx.idx < ctx.n - 1 else lab[-1:]
        new = torch.cat([row0_new, lab[1:-1], rowl_new], dim=0)
        # a capped local fixed point would force another round (the port's
        # has no cap, so conv is always True)
        changed = _flag(ctx, (new != lab).any() | (not conv))
        lab = new
        if not changed:
            break
    return torch.where(fg, lab, -1)


def _count_table(keys_row: torch.Tensor, slot: torch.Tensor, n_rows: int, k: int) -> torch.Tensor:
    """int32 [n_rows, k]: pixels per (row, slot) for slot in 0..k−1 (slot k
    counts nothing), by scatter-add: exact integers."""
    key = (keys_row.long() * (k + 1) + slot.long()).reshape(-1)
    out = torch.zeros(n_rows * (k + 1), dtype=torch.int32, device=slot.device)
    out.index_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    return out.reshape(n_rows, k + 1)[:, :k]


def sharded_extract_blobs(
    ctx: SpatialCtx,
    mask_own: torch.Tensor,
    max_blobs: int = 64,
    connectivity: int = 8,
    use_kernels: bool = True,
):
    """Row-sharded blob extraction, bit-identical to ``ops.cc.extract_blobs``
    on the gathered mask while a frame has at most ``N_CAND`` components.

    Root candidates are the ``N_CAND`` top-left-most roots, merged from
    each rank's own ``N_CAND`` (every global candidate is among its rank's);
    the per-row and per-column counts of each candidate are exact int32
    (scatter-adds), summed over ranks; bbox extremes combine by maximum.
    The ``max_blobs`` largest are taken with the lower candidate first
    among equal areas (a stable sort, as ``jax.lax.top_k``). Returns the
    ``Blobs`` table, the same on every rank."""
    from tracking_tpu_torch.ops.cc import blob_finalize, blob_row_moments

    h, w = mask_own.shape
    dev = mask_own.device
    n_glob = ctx.H * w
    lab = sharded_label(ctx, mask_own, connectivity, use_kernels=use_kernels)

    gy = ctx.row0 + torch.arange(h, dtype=torch.int32, device=dev)
    iota = gy[:, None] * w + torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    score = torch.where(lab == iota, n_glob - iota, 0).reshape(-1)
    top_loc = torch.topk(score, min(N_CAND, h * w)).values
    top_score = torch.topk(ctx.comm.all_gather(top_loc), N_CAND).values
    roots_c = torch.where(top_score > 0, n_glob - top_score, n_glob).to(torch.int32)  # ascending

    # each pixel's candidate (N_CAND where its label is none of them)
    k = torch.searchsorted(roots_c, lab.reshape(-1)).clamp(max=N_CAND - 1)
    hit = (roots_c[k] == lab.reshape(-1)) & (lab.reshape(-1) >= 0)
    cand = torch.where(hit, k, N_CAND).reshape(h, w)
    rows = torch.arange(h, device=dev)[:, None].expand(h, w)
    area_c = ctx.psum(_count_table(rows, cand, h, N_CAND).sum(dim=0, dtype=torch.int32))
    top_i = torch.sort(-area_c, stable=True).indices[:max_blobs]
    roots = roots_c[top_i]

    # each pixel's blob slot (max_blobs where its candidate was not taken)
    slot_of = torch.full((N_CAND + 1,), max_blobs, dtype=torch.int64, device=dev)
    slot_of[top_i] = torch.arange(top_i.numel(), device=dev)
    slot = slot_of[cand]
    cols = torch.arange(w, device=dev)[None, :].expand(h, w)
    cnt_rk = _count_table(rows, slot, h, max_blobs)
    cnt_wk = ctx.psum(_count_table(cols, slot, w, max_blobs))
    area_p, sy_p, ny0_p, y1_p = blob_row_moments(cnt_rk, gy, ctx.H)
    moments = (ctx.psum(area_p), ctx.psum(sy_p), ctx.pmax(ny0_p), ctx.pmax(y1_p))
    return blob_finalize(moments, cnt_wk, roots, ctx.H, w)


def sharded_postproc(
    ctx: SpatialCtx, raw_fg: torch.Tensor, is_fg: torch.Tensor, median_ksize: int, use_kernels: bool = True
):
    """Row-sharded SuBSENSE post-processing, bit-exact vs the unsharded
    ``morph_close -> fill_holes -> erode³ -> median -> dilate³``: each
    bounded stencil runs on a halo slab whose rows outside the image carry
    its border (dilate 0, erode 255, the median's edge replication by
    :meth:`SpatialCtx.clamp_rows`); the fill runs :func:`sharded_fill`.
    Returns (final u8, dil_inv bool), owned rows."""
    from tracking_tpu_torch.ops.filters import binary_median_blur
    from tracking_tpu_torch.ops.morphology import dilate, erode

    h = ctx.h_loc
    mr = median_ksize // 2
    F = mr + 3  # fg1 rows needed: median ±mr for final ±3 (dilate³)
    Ch = F + 3  # close rows needed: erode³ reach for fg1 ±F
    E = Ch + 2  # raw rows: dilate ±1 + erode ±1 for close ±Ch

    def shrink(slab, a: int, b: int):
        """Slab with halo a -> slab with halo b (a ≥ b)."""
        return slab[a - b : a - b + h + 2 * b]

    # close = erode(dilate(raw)): dilate pads 0, erode pads 255 at the image edge
    dil = ctx.fill_out_globe(dilate(ctx.extend_const(raw_fg, E, 0), 3), E, 255)
    close = erode(dil, 3)  # valid on ±Ch (the slab's edge rows are unused)
    filled_own = sharded_fill(ctx, shrink(close, E, 0).contiguous(), use_kernels=use_kernels)

    # fg1 = is_fg | holes | eroded³(close), on ±F rows
    close_F = shrink(close, E, F)
    er = ctx.fill_out_globe(shrink(close, E, Ch), Ch, 255)
    er_F = shrink(erode(erode(erode(er, 3), 3), 3), Ch, F)
    is_fg_F = ctx.extend_plain(is_fg, halo=F)
    filled_F = ctx.extend_plain(filled_own, halo=F)
    holes_F = (filled_F > 0) & ~(close_F > 0)
    fg1 = torch.where(is_fg_F | holes_F | (er_F > 0), 255, 0).to(torch.uint8)
    fg1 = ctx.clamp_rows(fg1, F)  # the median's edge replication

    final_3 = shrink(binary_median_blur(fg1, median_ksize), F, 3)
    final_own = shrink(final_3, 3, 0).contiguous()
    dilated = ctx.fill_out_globe(final_3, 3, 0)
    for _ in range(3):
        dilated = dilate(dilated, 3)
    return final_own, ~(shrink(dilated, 3, 0) > 0)


# -- state and entry points -------------------------------------------------------


def row_rule(h_global: int, batched: bool = False):
    """The dims rule of a state leaf (JAX's ``spatial_specs``): rows on
    ``space`` where the leaf's second-to-last axis is ``h_global``, the
    rest replicated; ``batched``: stacked along B, on ``stream``."""
    lead = ("stream",) if batched else ()

    def rule(shape):
        rest = len(shape) - len(lead)
        if rest >= 2 and shape[-2] == h_global:
            return lead + (None,) * (rest - 2) + ("space", None)
        return lead + (None,) * rest

    return rule


def spatial_specs(state, h_global: int):
    """The state's tree with True for each leaf whose second-to-last axis
    is ``h_global`` (row-sharded) and False for the rest (replicated)."""
    rule = row_rule(h_global)
    return map_tensors(lambda x: "space" in rule(tuple(x.shape)), state)


def _row_meta(state, specs):
    """The meta tree of one state split over ``space`` as ``specs`` marks."""
    if isinstance(state, dict):
        return {k: _row_meta(v, specs[k]) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return tuple(_row_meta(v, s) for v, s in zip(state, specs))
    dims = (None,) * (state.ndim - 2) + ("space", None) if specs else (None,) * state.ndim
    return Leaf(tuple(state.shape), state.dtype, dims)


def _rows_of(state, specs, n: int, r: int):
    """Rank ``r`` of ``n``'s part of a state: its rows of the sharded
    leaves, the replicated leaves whole, each a contiguous tensor of its
    own."""
    return map_tensors(lambda t: owned(t, t.device), block_of(state, _row_meta(state, specs), {"space": n}, r))


def shard_state(state, specs, n: int) -> list:
    """One state per rank: sharded leaves split into ``n`` row blocks,
    replicated leaves cloned (each a contiguous tensor of its own)."""
    return [_rows_of(state, specs, n, r) for r in range(n)]


def gather_state(states: list, specs):
    """The ranks' states joined: sharded leaves concatenated along rows,
    replicated leaves taken from rank 0."""
    return join(states, _row_meta(states[0], specs), {"space": len(states)})


def _replicated(shape) -> tuple:
    return (None,) * len(shape)


def _one_stream(shape) -> tuple:
    """A stream's frames [T, H, W(, C)] or masks: rows on ``space``."""
    return (None, "space") + (None,) * (len(shape) - 2)


def _check_algo(algo) -> None:
    if "ctx" not in inspect.signature(algo.step).parameters:
        raise ValueError(
            f"{type(algo).__name__}.step has no spatial-context support; the port shards SuBSENSE and LOBSTER"
        )


def _stream_mesh(mesh: Optional[Mesh], n_shards: int, frames, *placed) -> Mesh:
    """The mesh of a one-stream run: ``mesh``, that of its placed inputs,
    or ``n_shards`` threads on the frames' device."""
    if mesh is None:
        mesh = placed_mesh(frames, *placed)
    return Mesh(1, n_shards, frames.device) if mesh is None else mesh


def _state_meta(algo, states, frames_shape, axes):
    """The meta tree of one stream's state: ``states``', or that of an
    ``init`` state on the ``meta`` device where the call makes it."""
    t, h, w = frames_shape[:3]
    if states is None:
        states = algo.init(h, w, frames_shape[3] if len(frames_shape) == 4 else 1, device="meta")
    return meta_of(states, row_rule(h), axes)


def _init_rows(algo, ctx: SpatialCtx, rows: torch.Tensor):
    """A stream's state made on this rank: ``init`` and ``warm_start`` on
    its whole first frame (its ``rows`` gathered over the row's ranks),
    then this rank's part (:func:`shard_state`'s)."""
    full = ctx.comm.all_gather(rows, dim=0)
    c = full.shape[2] if full.ndim == 3 else 1
    state = algo.warm_start(algo.init(ctx.H, full.shape[1], c, device=full.device), full)
    return _rows_of(state, spatial_specs(state, ctx.H), ctx.n, ctx.idx)


def _frame_slabs(ctx: SpatialCtx, own: torch.Tensor) -> torch.Tensor:
    """This rank's rows of every frame [T, h_loc, W(, C)], halo-extended
    once for the chunk: [T, h_loc + 2·halo, W(, C)]."""
    if own.ndim == 4:
        return ctx.extend_plain(own.movedim(3, 1)).movedim(1, 3)
    return ctx.extend_plain(own)


def _spatial_rank(rank, comm, algo, h: int, state, own: torch.Tensor, use_kernels: bool):
    """One rank of :func:`run_video_spatial`: (state, masks [T, h_loc, W]);
    ``state`` the rank's own, or None (made here)."""
    ctx = SpatialCtx(comm.axis("space"), h, device=own.device)
    if state is None:
        state = _init_rows(algo, ctx, own[0])
    masks = []
    for fr in _frame_slabs(ctx, own):
        state, fg, _ = algo.step(state, fr, use_kernels=use_kernels, ctx=ctx)
        masks.append(fg)
    return state, torch.stack(masks)


def _finish(mesh: Mesh, out: list, kept: list, metas: Sequence, placed: bool) -> list:
    """A runner's states: placed handles of the kept blocks, or the blocks
    (results 0.. of each rank) joined on the mesh's device."""
    if placed:
        return [MeshArray(mesh, meta, k) for meta, k in zip(metas, kept)]
    return [join([o[i] for o in out], meta, mesh.shape) for i, meta in enumerate(metas)]


def run_video_spatial(
    algo, frames, n_shards: int = 4, states=None, use_kernels: bool = True, mesh: Optional[Mesh] = None,
):
    """ONE stream, row-sharded over the ``space`` axis of ``mesh`` (a thread
    or process mesh), or over ``n_shards`` threads on the frames' device.
    frames [T, H, W(, C)] u8, H divisible by the shard count, a tensor or
    placed on the mesh with its rows on ``space`` (``placed.place(frames,
    mesh, (None, "space"))``); ``states`` a tensor tree, placed by an
    earlier call, or None (made on the ranks). Returns (final state, masks
    [T, H, W] on the mesh's device), bit-identical to the unsharded
    ``run_video``: the state on the mesh's device where frames and states
    are tensors, else placed (rows on ``space``, the rest replicated)."""
    _check_algo(algo)
    mesh = _stream_mesh(mesh, n_shards, frames, states)
    h, n = frames.shape[1], mesh.size
    if h % mesh.space:
        raise ValueError(f"height {h} does not split into {mesh.space} shards")
    placed = placed_mesh(frames, states) is not None
    meta = _state_meta(algo, states, frames.shape, mesh.shape)
    out, kept = mesh.run(_spatial_rank, [algo] * n, [h] * n, rank_args(mesh, states, row_rule(h), clone=True),
                         rank_args(mesh, frames, _one_stream), [use_kernels] * n, keep=(0,) if placed else ())
    masks = join([o[1] for o in out], meta_leaf(frames.shape[:3], _one_stream, mesh.shape), mesh.shape)
    return _finish(mesh, out, kept, [meta], placed)[0], masks


def _batch_spatial_rank(rank, comm, algo, h: int, states, own: torch.Tensor, use_kernels: bool):
    """Rank (i, j) of :func:`run_video_batch_spatial`: its streams' row
    block j, [per, T, h_loc, W(, C)], stepped over its stream row's
    ``space`` view; ``states`` the rank's own stacked block, or None (made
    here). Returns (states stacked along B, masks)."""
    ctx = SpatialCtx(comm.axis("space"), h, device=own.device)
    if states is None:
        sts = [_init_rows(algo, ctx, f[0]) for f in own]
    else:
        sts = split_states(states, own.shape[0], copy=False)
    slabs = torch.stack([_frame_slabs(ctx, f) for f in own])
    sts, masks = run_streams(algo, sts, slabs, use_kernels, ctx=ctx)
    return stack_states(sts), masks


def run_video_batch_spatial(algo, frames, mesh: Mesh, states=None, use_kernels: bool = True):
    """Streams × row shards (``tracking_tpu`` ``run_video_batch_spatial``):
    frames [B, T, H, W(, C)] on the ``stream`` × ``space`` ranks of
    ``mesh``; rank (i, j) owns B/stream streams of block i and the H/space
    rows of block j of each, and steps its streams frame by frame, ``t``
    outer and stream inner, with a :class:`SpatialCtx` over the ``space``
    view of its stream row (``parallel/mesh.py``: each row synchronises
    only with itself; the stream axis runs no collective). frames a tensor
    or placed by ``shard_video_batch``; ``states`` stacked along B, as
    tensors or placed by an earlier call, or None: each rank makes and
    warm-starts its streams unsharded, then keeps its rows. Returns
    (states, masks [B, T, H, W] on the mesh's device), bit-identical to
    each stream's unsharded run: the states stacked along B on the mesh's
    device where frames and states are tensors, else placed (B on
    ``stream``, rows on ``space``)."""
    _check_algo(algo)
    b, h = frames.shape[0], frames.shape[2]
    if b % mesh.stream or h % mesh.space:
        raise ValueError(f"a batch of {b} streams x {h} rows does not split over the mesh {mesh.shape}")
    n, rule = mesh.size, row_rule(h, batched=True)
    placed = placed_mesh(frames, states) is not None
    meta = batch_state_meta(algo, states, frames.shape, rule, mesh.shape)
    out, kept = mesh.run(_batch_spatial_rank, [algo] * n, [h] * n, rank_args(mesh, states, rule, clone=True),
                         rank_args(mesh, frames, batch_dims), [use_kernels] * n,
                         keep=(0,) if placed else ())
    masks = join([o[1] for o in out], meta_leaf(frames.shape[:4], batch_dims, mesh.shape), mesh.shape)
    return _finish(mesh, out, kept, [meta], placed)[0], masks


def _tracked_rank(rank, comm, algo, tracker, h: int, state, ts, own: torch.Tensor, pipelined: bool,
                  use_kernels: bool):
    """One rank of :func:`run_video_spatial_tracked`: (state, tracker state,
    masks [T, h_loc, W], tracks_x [T, K] on rank 0, else None); ``state``
    and ``ts`` the rank's own, or None (made here)."""
    ctx = SpatialCtx(comm.axis("space"), h, device=own.device)
    if state is None:
        state = _init_rows(algo, ctx, own[0])
    if ts is None:
        ts = tracker.init(device=own.device)
    k_blobs = tracker.config.maxBlobs
    masks, xs, pending = [], [], None

    def track(fg, blobs):
        nonlocal ts
        ts, tracks = tracker.step(ts, fg, use_kernels=use_kernels, blobs=blobs, ctx=ctx)
        xs.append(tracks.x)

    for fr in _frame_slabs(ctx, own):
        if pipelined and pending is not None:
            track(*pending)  # tracking(t - 1), before BGS(t)
        state, fg, _ = algo.step(state, fr, use_kernels=use_kernels, ctx=ctx)
        blobs = sharded_extract_blobs(ctx, fg, max_blobs=k_blobs, use_kernels=use_kernels)
        masks.append(fg)
        if pipelined:
            pending = (fg, blobs)
        else:
            track(fg, blobs)
    if pipelined:
        track(*pending)
    return state, ts, torch.stack(masks), torch.stack(xs) if rank == 0 else None


def run_video_spatial_tracked(
    algo,
    tracker,
    frames,
    n_shards: int = 4,
    states=None,
    pipelined: bool = False,
    use_kernels: bool = True,
    mesh: Optional[Mesh] = None,
    tracker_state=None,
):
    """ONE stream through the whole sharded pipeline, over the ``space``
    axis of ``mesh`` (a thread or process mesh) or over ``n_shards``
    threads on the frames' device: the row-sharded BGS step and
    post-processing, :func:`sharded_extract_blobs`, then the replicated
    tracker (CC or CCMSPF, whose mean-shift collision refinement sums
    window moments over ranks). Masks, per-frame tracks and states are
    bit-identical to the unsharded ``step -> tracker.step`` chain.

    ``pipelined=True`` runs tracking one frame behind the BGS stage: step
    ``t`` enqueues tracking(t − 1) before BGS(t), the same tracker calls on
    the same inputs in the same order, then drains the last frame.

    frames, ``states`` and ``tracker_state`` as tensors, or placed (as in
    :func:`run_video_spatial`; the tracker state replicated on every rank,
    JAX's ``P()``), or None for the states (made on the ranks). Returns
    (bgs state, tracker state, masks [T, H, W], tracks_x [T, K]): the
    states on the mesh's device where every input is a tensor, else
    placed."""
    _check_algo(algo)
    ttype = tracker.config.trackerType.upper()
    if ttype not in ("CC", "CCMSPF"):
        raise ValueError("the sharded tracked pipeline supports the CC and CCMSPF trackers")
    mesh = _stream_mesh(mesh, n_shards, frames, states, tracker_state)
    h, n = frames.shape[1], mesh.size
    if h % mesh.space:
        raise ValueError(f"height {h} does not split into {mesh.space} shards")
    placed = placed_mesh(frames, states, tracker_state) is not None
    metas = [_state_meta(algo, states, frames.shape, mesh.shape),
             meta_of(tracker.init(device="meta") if tracker_state is None else tracker_state, _replicated,
                     mesh.shape)]
    out, kept = mesh.run(_tracked_rank, [algo] * n, [tracker] * n, [h] * n,
                         rank_args(mesh, states, row_rule(h), clone=True),
                         rank_args(mesh, tracker_state, _replicated, clone=True), rank_args(mesh, frames, _one_stream),
                         [pipelined] * n, [use_kernels] * n, keep=(0, 1) if placed else ())
    masks = join([o[2] for o in out], meta_leaf(frames.shape[:3], _one_stream, mesh.shape), mesh.shape)
    state, ts = _finish(mesh, out, kept, metas, placed)
    return state, ts, masks, out[0][3]
