"""Exact integer min cut on a 4-connected grid (Boykov–Kolmogorov parity),
counterpart of ``tracking_tpu/ops/mincut.py``: LbpMrf's MRF mask.

The reference (``ck/MotionDetection.cpp:1279-1321``) builds a grid graph
with integer terminal capacities (BK cancels parallel terminal edges, so a
node carries ``tr_cap = cap_source − cap_sink``) and unit 4-neighbour
edges, runs BK max-flow and labels ``what_segment == SINK`` as foreground:
the nodes NOT reachable from the source in the final residual graph. That
set does not depend on which maximum flow was found, so the mask is the
result to match; the port runs the JAX package's algorithm all the same,
in int32: lock-step push–relabel with exact global relabels (phase 1
routes excess to the abundant terminal, phase 2 returns what is trapped),
the orientation picked by the two capacity sums (the excess lives on the
smaller side), then the source's residual reachability.

The JAX package's ``while_loop``s are Python loops whose exit tests read
the card: a distance sweep (four whole-line relaxations) repeats until it
changes nothing, and a drain round (a global relabel, then eight
push / relabel rounds) repeats while some excess can still move, at most
``4·H·W`` times. A whole-line relaxation is a segmented running minimum;
the port takes it with one ``torch.cummin`` over segment-offset keys, along
the innermost dim of a transposed or flipped copy where the line runs
another way (the JAX package doubles over shifted copies; both give the
same integers).
:data:`STATS` counts the drain rounds, the distance sweeps and the host
reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# direction order: (dy, dx) for up, down, left, right
_DIRS = ((-1, 0), (1, 0), (0, -1), (0, 1))
STATS = {"drain_rounds": 0, "sweeps": 0, "host_reads": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def _read(flag: torch.Tensor) -> bool:
    STATS["host_reads"] += 1
    return bool(flag)


def _nbr(a: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """Value at (y + dy, x + dx), ``fill`` outside the grid."""
    H, W = a.shape
    p = F.pad(a, (1, 1, 1, 1), value=fill)
    return p[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]


_SEG = 1 << 40  # a segment's key offset, above any |d ∓ index|


def _layout(a: torch.Tensor, axis: int, reverse: bool) -> torch.Tensor:
    """``a`` with the scan along dim 1 in scan order (contiguous: torch
    scans the innermost dim of a contiguous tensor several times faster
    than an outer one)."""
    if axis == 0:
        a = a.t()
    return (a.flip(1) if reverse else a).contiguous()


def _unlayout(a: torch.Tensor, axis: int, reverse: bool) -> torch.Tensor:
    a = a.flip(1) if reverse else a
    return a.t() if axis == 0 else a


def _segment_keys(open_step: torch.Tensor) -> torch.Tensor:
    """[R, L] bool in scan layout -> int64 −(segment number)·_SEG: a new
    segment starts wherever the step edge into a cell is missing."""
    return torch.cumsum((~open_step).to(torch.int64), dim=1) * -_SEG


def _scan_rows(d: torch.Tensor, seg: torch.Tensor, idx: torch.Tensor, inf: int) -> torch.Tensor:
    """f[i] = min(d[i], f[i − 1] + 1) along dim 1 within segments. With
    g = d − i the recurrence is a segmented running minimum of g; the
    segment keys make the current segment's keys smaller than every earlier
    one's, so a plain running minimum stays inside the segment."""
    run = torch.cummin(d.to(torch.int64) - idx + seg, dim=1).values - seg
    return torch.minimum(d, torch.clamp(run + idx, max=inf).to(torch.int32))


def _line_keys(open_step: torch.Tensor, axis: int, reverse: bool):
    """The segment keys and indices of a whole-line relaxation along
    ``axis`` (reversed or not), in scan layout. They depend only on the
    open step edges, so ``_dist_via`` makes them once a call."""
    op = _layout(open_step, axis, reverse)
    idx = torch.arange(op.shape[1], device=op.device, dtype=torch.int64)[None]
    return _segment_keys(op), idx


def _line_pass(d: torch.Tensor, keys, axis: int, reverse: bool, inf: int) -> torch.Tensor:
    """One whole-line relaxation, f[i] = min(d[i], f[prev] + 1) along the
    scan direction, the +1 chain broken where the step edge into i is
    missing (``keys`` from :func:`_line_keys`); the JAX package's
    ``_line_pass``."""
    seg, idx = keys
    return _unlayout(_scan_rows(_layout(d, axis, reverse), seg, idx, inf), axis, reverse)


def _dist_via(seed_d: torch.Tensor, opens, inf: int) -> torch.Tensor:
    """d(v) = min(seed_d(v), 1 + min over open step edges into v of
    d(prev)), by four-direction whole-line sweeps to a fixed point
    (``opens`` = (from-up, from-down, from-left, from-right) in _DIRS
    order; each sweep left, right, down, up, as the JAX package)."""
    passes = [(axis, reverse, _line_keys(op, axis, reverse))
              for axis, reverse, op in ((1, False, opens[2]), (1, True, opens[3]), (0, False, opens[0]),
                                        (0, True, opens[1]))]
    d = seed_d
    while True:
        nd = d
        for axis, reverse, keys in passes:
            nd = _line_pass(nd, keys, axis, reverse, inf)
        STATS["sweeps"] += 1
        if not _read((nd != d).any()):
            return torch.clamp(nd, max=inf).contiguous()
        d = nd


def _push_phase(e, h, rterm, res, n: int):
    """One lock-step push round (``mincut.py:146-186``): the terminal edge
    first (admissible at h == 1), then the four grid edges in _DIRS order
    from a frozen budget; received flow enters next round's excess."""
    active = (e > 0) & (h < n)
    budget = torch.where(active, e, 0)
    amt = torch.where(active & (h == 1) & (rterm > 0), torch.minimum(budget, rterm), 0)
    rterm = rterm - amt
    budget = budget - amt
    sent = amt
    new_res, recv = list(res), []
    for i, (dy, dx) in enumerate(_DIRS):
        adm = active & (new_res[i] > 0) & (h == _nbr(h, dy, dx, n + 1) + 1)
        amt = torch.where(adm, torch.minimum(budget, new_res[i]), 0)
        new_res[i] = new_res[i] - amt
        budget = budget - amt
        sent = sent + amt
        recv.append(amt)
    inc = torch.zeros_like(e)
    for i, (dy, dx) in enumerate(_DIRS):
        got = _nbr(recv[i ^ 1], dy, dx, 0)  # the neighbour's push toward me
        new_res[i] = new_res[i] + got
        inc = inc + got
    return e - sent + inc, rterm, tuple(new_res)


def _relabel(e, h, rterm, res, n: int):
    """Jacobi relabel (``mincut.py:189-201``)."""
    active = (e > 0) & (h < n)
    best = torch.where(rterm > 0, 1, n)
    adm = (rterm > 0) & (h == 1)
    for i, (dy, dx) in enumerate(_DIRS):
        hn = _nbr(h, dy, dx, n)
        best = torch.minimum(best, torch.where(res[i] > 0, hn + 1, n))
        adm = adm | ((res[i] > 0) & (h == hn + 1))
    return torch.where(active & ~adm, torch.maximum(h, torch.clamp(best, max=n)), h).to(torch.int32)


def _drain(e, rterm, res, n: int, max_outer: int):
    """Route as much excess as possible into the terminal whose residual
    edges are ``rterm`` (``mincut.py:204-241``)."""
    it = 0
    while it < max_outer:
        seed = torch.where(rterm > 0, 1, n).to(torch.int32)
        h = _dist_via(seed, tuple(r > 0 for r in res), n)
        it += 1
        STATS["drain_rounds"] += 1
        if not _read(((e > 0) & (h < n)).any()):
            break
        for _ in range(8):
            e, rterm, res = _push_phase(e, h, rterm, res, n)
            h = _relabel(e, h, rterm, res, n)
    return e, rterm, res


def grid_mincut_sink_mask(tr_cap: torch.Tensor, e_up: torch.Tensor, e_left: torch.Tensor) -> torch.Tensor:
    """BK-parity min cut on a 4-connected grid. ``tr_cap`` [H, W] int32: net
    terminal capacity (cap_source − cap_sink); ``e_up`` / ``e_left`` [H, W]
    bool: the unit edge to (y − 1, x) / (y, x − 1) exists. Returns FG
    [H, W] bool: True where the node is not reachable from the source in
    the final residual graph."""
    H, W = tr_cap.shape
    n = H * W + 2
    i32 = torch.int32
    rs0 = torch.clamp(tr_cap, min=0).to(i32)  # source -> v
    rt = torch.clamp(-tr_cap, min=0).to(i32)  # v -> sink
    up, left = e_up.to(i32), e_left.to(i32)
    res = (up, _nbr(up, 1, 0, 0), left, _nbr(left, 0, 1, 0))

    def run(e0, rterm1, back0):
        e, r1_rem, res2 = _drain(e0, rterm1, res, n, 4 * H * W)
        e, r2_rem, res2 = _drain(e, back0, res2, n, 4 * H * W)
        return r1_rem, r2_rem, res2

    if _read(rt.sum() <= rs0.sum()):
        # excess from the sink side on the reversed graph: drain to the
        # source, refund to the sink; the source residual is what stays
        rs_fin, _, res2 = run(rt, rs0, rt)
        opens = tuple(r > 0 for r in res2)
    else:
        # excess from the source: drain to the sink, refund to the source;
        # a residual edge u -> v sits at u, so reachability reads the
        # neighbour's edge
        _, back_after, res2 = run(rs0, rt, rs0)
        rs_fin = rs0 - back_after
        opens = tuple(_nbr(res2[i ^ 1], dy, dx, 0) > 0 for i, (dy, dx) in enumerate(_DIRS))
    seed = torch.where(rs_fin > 0, 0, n).to(i32)
    return ~(_dist_via(seed, opens, n) < n)
