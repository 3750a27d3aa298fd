"""SJN_MultiCueBGS (ustc type 34, Noh and Jeon's multi-cue codebooks),
counterpart of ``tracking_tpu/bgs/multicue.py``.

At a fixed reduced resolution (160×120 by default): nearest subsampling,
a 7×7 σ = 0.7 Gaussian, BGR → "HSVxyz" (X, Y = V·S·cos / sin(H)·127.5 +
127.5, Z = V·255); texture codebooks over six centre − neighbour Z
differences and colour codebooks over XYZ, each with a cache-book; the
first 21 frames train. A detection frame builds a landmark map (texture
confidence, colour matching on textureless pixels), a 5×5 ≥ 12 count map,
the bounding boxes of its 4-connected components (``ops/cc.extract_blobs``:
the CUDA labelling kernel on the card), a ghost test on each box (Canny
edges of the frame and of the candidate map, ``ops/canny``, against a
12-step chamfer field), re-learns ghost boxes into the background, updates
the background books outside the valid boxes and the cache-books inside
(absorbing codewords seen 200 frames in a row), and enlarges the reduced
map bilinearly to the frame (``ops/resize``).

The state is the JAX package's nested tree (``tmodel``, ``tcache``,
``cmodel``, ``ccache`` with ``mean``, ``first``, ``last``, ``mnrl``, ``n``,
``total``; ``t_ref``, ``t_cnt``, ``c_ref``, ``c_cnt``; ``t``), the fixed
capacities included. The JAX package's two ``lax.cond``s on ``t`` (training
against detection, the end of training) read ``t`` on the host once a
frame and run only the branch taken. A codebook compaction is one stable
sort of the kept flags along K and a gather (the JAX package unrolls
K(K+1)/2 selects); the slots past the kept count keep their values, as
there. Float order as XLA:CPU runs the JAX step (read from its optimized
HLO): ``x / 255`` and ``/ NN`` are products by f32 reciprocals, ``hh ·
2π / 360`` one product by the folded constant, the detection bands
``mean ∓ 15 ∓ 5`` one addition of ∓20, ``x - c`` an addition of −c;
``sin`` and ``cos`` are XLA:CPU's (``ops/xla_math``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops import xla_math
from tracking_tpu_torch.ops.canny import canny
from tracking_tpu_torch.ops.cc import extract_blobs
from tracking_tpu_torch.ops.color import bgr2gray_u8, fold
from tracking_tpu_torch.ops.consensus import recip
from tracking_tpu_torch.ops.filters import gaussian_blur
from tracking_tpu_torch.ops.lbsp import edge_pad
from tracking_tpu_torch.ops.resize import resize_bilinear
from tracking_tpu_torch.track.meanshift import sequential_sum

PI = 3.14159  # SJN_MultiCueBGS.h:23
# neighbour directions (dx, dy), T_SetNeighborDirection (:1662-1708)
_DIRS = [(-2, 0), (-1, -2), (1, -2), (2, 0), (1, 2), (-1, 2)]
NN = 6
RADIUS = 2
MAX_BOXES = 64
_INV255 = recip(255.0)
_HRAD = fold(2.0 * PI, recip(360.0))
_INV_NN = recip(NN)
_CHAMFER = [(-1, -1, 1.4142), (-1, 0, 1.0), (-1, 1, 1.4142), (0, -1, 1.0),
            (0, 1, 1.0), (1, -1, 1.4142), (1, 0, 1.0), (1, 1, 1.4142)]
_INF = 1e9


def _hsv_xyz(bgr_u8: torch.Tensor) -> torch.Tensor:
    """BGR2HSVxyz_Par (:568-622): [H, W, 3] u8 -> XYZ u8."""
    f32 = torch.float32
    b, g, r = (bgr_u8[..., i].to(f32) * _INV255 for i in range(3))
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    one = torch.ones((), dtype=f32, device=bgr_u8.device)
    v = mx
    s = torch.where(v == 0, 0.0, (mx - mn) / torch.where(mx == 0, one, mx))
    # the reference divides by S, not by max - min
    safe_s = torch.where(s == 0, one, s)
    h_r = 60.0 * (g - b) / safe_s
    h_r = torch.where(h_r < 0, 360.0 + h_r, h_r)
    h_g = 120.0 + 60.0 * (b - r) / safe_s
    h_b = 240.0 + 60.0 * (r - g) / safe_s
    hh = torch.where(mx == r, h_r, torch.where(mx == g, h_g, h_b))
    hh = torch.where((v == 0) | (s == 0), 0.0, hh)
    hrad = hh * _HRAD
    vs = v * s
    x = (vs * xla_math.cos(hrad) * 127.5 + 127.5).to(torch.uint8)
    y = (vs * xla_math.sin(hrad) * 127.5 + 127.5).to(torch.uint8)
    z = (v * 255.0).to(torch.uint8)
    return torch.stack([x, y, z], dim=-1)


def _kidx(K: int, like: torch.Tensor) -> torch.Tensor:
    """arange(K) shaped to broadcast against a [K, *like.shape] book."""
    return torch.arange(K, device=like.device).reshape((K,) + (1,) * like.ndim)


def _expand(idx: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """A [M, *lead] index broadcast over ``a``'s trailing payload dims."""
    extra = a.ndim - idx.ndim
    return idx.reshape(idx.shape + (1,) * extra).expand(idx.shape + a.shape[idx.ndim :])


def _compact_sources(keep: torch.Tensor) -> torch.Tensor:
    """[K, ...] bool -> [K, ...] int64 source slot of each slot after a
    stable compaction: the m-th kept slot for m below the kept count, the
    slot itself past it (its old value stays)."""
    K = keep.shape[0]
    order = torch.sort((~keep).to(torch.uint8), dim=0, stable=True).indices
    kcnt = keep.sum(dim=0, dtype=torch.int64)
    ks = _kidx(K, kcnt)
    return torch.where(ks < kcnt[None], order, ks)


def _compacted(a: torch.Tensor, src: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """``a`` compacted along K by ``src`` where ``cond`` (the book's lead
    shape), unchanged elsewhere."""
    out = torch.gather(a, 0, _expand(src, a))
    c = cond.reshape((1,) + cond.shape + (1,) * (a.ndim - 1 - cond.ndim))
    return torch.where(c, out, a)


def _first_true(mask: torch.Tensor):
    """(any, first index, 0 where none) along axis 0."""
    return mask.any(dim=0), torch.argmax(mask.to(torch.uint8), dim=0)


@dataclasses.dataclass(frozen=True)
class MultiCueConfig(BGSConfig):
    showOutput: bool = True
    # reference ctor constants (SJN_MultiCueBGS.cpp:25-61)
    trainingPeriod: int = 20
    T_ModelThreshold: int = 1
    C_ModelThreshold: int = 10  # unused by the effective code path
    learningRate: float = 0.05
    textureTrainVolRange: int = 15
    colorTrainVolRange: int = 20
    absorptionEnable: bool = True
    absorptionPeriod: int = 200
    reducedWidth: int = 160
    reducedHeight: int = 120
    backClearPeriod: int = 300
    cacheClearPeriod: int = 30  # declared but the code passes 10 (:425-427)
    # capacity caps (fixed shapes; see the JAX module's docstring)
    modelCapacity: int = 24
    cacheCapacity: int = 12


@register("SJN_MultiCueBGS", type_id=34, aliases=("multicue",))
class MultiCue(BGSAlgorithm):
    Config = MultiCueConfig

    # ---------------- codebook primitives (axis 0 = K) ----------------------
    @staticmethod
    def _construct(book, match, new_val_fn, upd_val_fn, do):
        """Shared codeword bookkeeping for one frame (``multicue.py:196-230``).
        Returns (book, matched?, matched index, appended slot)."""
        n = book["n"]
        K = book["mnrl"].shape[0]
        ks = _kidx(K, n)
        active = ks < n
        has, first = _first_true(match & active)
        has = has & do
        total = torch.where(do, book["total"] + 1, book["total"])
        stale = torch.where(active, book["mnrl"], -1)
        slot = torch.where(n < K, n, torch.argmax(stale, dim=0).to(torch.int32))
        appending = do & ~has
        at_slot = (ks == slot) & appending
        at_match = (ks == first) & has
        out = dict(book)
        out["total"] = total
        out["n"] = torch.where(appending, torch.clamp(n + 1, max=K), n)
        out["first"] = torch.where(at_slot, total, book["first"])
        out["last"] = torch.where(at_slot, total, torch.where(at_match, total, book["last"]))
        out["mnrl"] = torch.where(at_slot, total - 1, book["mnrl"])
        out = new_val_fn(out, at_slot)
        out = upd_val_fn(out, at_match)
        return out, has, first.to(torch.int32), slot

    @staticmethod
    def _clear(book, clear_num, do):
        """T/C_ClearNonEssentialEntries (:1423-1489, :1901-1960)."""
        n = book["n"]
        K = book["mnrl"].shape[0]
        active = _kidx(K, n) < n
        fire = do & (book["total"] >= clear_num)
        keep = (book["mnrl"] <= clear_num // 2) & active
        kcnt = keep.sum(dim=0, dtype=torch.int32)
        compact = fire & ~((kcnt == 0) | (kcnt == n))
        src = _compact_sources(keep)
        out = dict(book)
        for name in ("first", "last", "mnrl", "mean"):
            out[name] = _compacted(book[name], src, compact)
        reset = fire & active  # times reset on every fired pixel
        out["first"] = torch.where(reset, 1, out["first"])
        out["last"] = torch.where(reset, 1, out["last"])
        out["mnrl"] = torch.where(reset, 0, out["mnrl"])
        out["n"] = torch.where(compact, kcnt, n)
        out["total"] = torch.where(fire, 0, book["total"])
        return out

    @staticmethod
    def _cache_clear(book, landmark_is_fg, ref, clear_num, do, stale=5):
        """T/C_ClearNonEssentialEntriesForCachebook (:1494-1560)."""
        n = book["n"]
        K = book["mnrl"].shape[0]
        ks = _kidx(K, n)
        active = ks < n
        young = do & (book["total"] < clear_num)
        keep_ref = landmark_is_fg[None] & (ks == ref[None])
        out = dict(book)
        out["mnrl"] = torch.where(young[None] & active, torch.where(keep_ref, 0, book["mnrl"] + 1), book["mnrl"])
        out["total"] = torch.where(young, book["total"] + 1, book["total"])
        fire = do & ~young
        keep = (book["mnrl"] < stale) & active
        kcnt = keep.sum(dim=0, dtype=torch.int32)
        src = _compact_sources(keep)
        for name in ("first", "last", "mnrl", "mean"):
            out[name] = _compacted(out[name], src, fire)
        out["mnrl"] = torch.where(fire[None] & active, 0, out["mnrl"])
        out["n"] = torch.where(fire, kcnt, out["n"])
        out["total"] = torch.where(fire, 0, out["total"])
        return out

    @staticmethod
    def _absorb(model, cache, ref, cnt, period, do):
        """T/C_Absorption (:1612-1659): cache[ref] appended to the model."""
        Km, Kc = model["mnrl"].shape[0], cache["mnrl"].shape[0]
        fire = do & (cnt >= period) & (ref >= 0) & (ref < Kc)
        ks_m, ks_c = _kidx(Km, model["n"]), _kidx(Kc, cache["n"])
        refc = torch.clamp(ref, 0, Kc - 1)
        total2 = torch.where(fire, model["total"] + 1, model["total"])
        stale = torch.where(ks_m < model["n"], model["mnrl"], -1)
        slot = torch.where(model["n"] < Km, model["n"], torch.argmax(stale, dim=0).to(torch.int32))
        at = (ks_m == slot) & fire[None]
        out_m = dict(model)
        out_m["total"] = total2
        out_m["n"] = torch.where(fire, torch.clamp(model["n"] + 1, max=Km), model["n"])
        out_m["first"] = torch.where(at, total2[None], model["first"])
        out_m["last"] = torch.where(at, total2[None], model["last"])
        out_m["mnrl"] = torch.where(at, total2[None] - 1, model["mnrl"])
        mean_c = cache["mean"]
        cval = torch.gather(mean_c, 0, _expand(refc.long()[None], mean_c))
        out_m["mean"] = torch.where(at.reshape(at.shape + (1,) * (mean_c.ndim - at.ndim)), cval, model["mean"])
        # remove ref from the cache: compact out that slot
        keep = ~((ks_c == refc) & fire[None]) & (ks_c < cache["n"])
        src = _compact_sources(keep)
        out_c = dict(cache)
        for name in ("first", "last", "mnrl", "mean"):
            out_c[name] = _compacted(cache[name], src, fire)
        out_c["n"] = torch.where(fire, torch.clamp(cache["n"] - 1, min=0), cache["n"])
        return out_m, out_c

    # ---------------- init ---------------------------------------------------
    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        cfg = self.config
        RH, RW = cfg.reducedHeight, cfg.reducedWidth
        kw = dict(device=device)

        def book(cap, lead, payload=()):
            i32 = dict(dtype=torch.int32, **kw)
            return {"mean": torch.zeros((cap,) + lead + payload, dtype=torch.float32, **kw),
                    "first": torch.zeros((cap,) + lead, **i32), "last": torch.zeros((cap,) + lead, **i32),
                    "mnrl": torch.zeros((cap,) + lead, **i32), "n": torch.zeros(lead, **i32),
                    "total": torch.zeros(lead, **i32)}

        K, Kc = cfg.modelCapacity, cfg.cacheCapacity
        return {
            "t": torch.zeros((), dtype=torch.int32, **kw),
            "tmodel": book(K, (NN, RH, RW)),
            "tcache": book(Kc, (NN, RH, RW)),
            "cmodel": book(K, (RH, RW), (3,)),
            "ccache": book(Kc, (RH, RW), (3,)),
            "t_ref": torch.full((NN, RH, RW), -1, dtype=torch.int32, **kw),
            "t_cnt": torch.zeros((NN, RH, RW), dtype=torch.int32, **kw),
            "c_ref": torch.full((RH, RW), -1, dtype=torch.int32, **kw),
            "c_cnt": torch.zeros((RH, RW), dtype=torch.int32, **kw),
        }

    # ---------------- per-frame pieces ---------------------------------------
    def _preprocess(self, frame):
        cfg = self.config
        RH, RW = cfg.reducedHeight, cfg.reducedWidth
        h, w = frame.shape[:2]
        f64 = dict(dtype=torch.float64, device=frame.device)
        ys = (torch.arange(RH, **f64) * (h / RH)).to(torch.int64)
        xs = (torch.arange(RW, **f64) * (w / RW)).to(torch.int64)
        small = frame.index_select(0, ys).index_select(1, xs)
        return _hsv_xyz(gaussian_blur(small, 7, 0.7)), small

    @staticmethod
    def _tex_diffs(z):
        """Z plane [RH, RW] f32 -> [NN, RH, RW] centre - neighbour
        differences over a replicated border (only inset pixels are read)."""
        RH, RW = z.shape
        p = edge_pad(z, 2, 2, 2, 2)
        return torch.stack([z - p[2 + dy : 2 + dy + RH, 2 + dx : 2 + dx + RW] for dx, dy in _DIRS])

    def _t_construct(self, book, diffs, lr, do, is_model, st):
        k = self.config.textureTrainVolRange
        d = diffs[None]
        match = (book["mean"] + float(-k) <= d) & (d <= book["mean"] + float(k))

        def new_val(out, at):
            out["mean"] = torch.where(at, d, out["mean"])
            return out

        def upd_val(out, at):
            out["mean"] = torch.where(at, lr * d + (1 - lr) * out["mean"], out["mean"])
            return out

        book, has, first, slot = self._construct(book, match, new_val, upd_val, do)
        return self._refs(book, has, first, slot, do, is_model, st, "t_ref", "t_cnt")

    def _c_construct(self, book, xyz_f, lr, do, is_model, st):
        k = self.config.colorTrainVolRange
        px = xyz_f[None]
        mean = book["mean"]
        match = ((mean + float(-k) <= px) & (px <= mean + float(k))).all(dim=-1)

        def new_val(out, at):
            out["mean"] = torch.where(at[..., None], px, out["mean"])
            return out

        def upd_val(out, at):
            out["mean"] = torch.where(at[..., None], lr * px + (1 - lr) * out["mean"], out["mean"])
            return out

        book, has, first, slot = self._construct(book, match, new_val, upd_val, do)
        return self._refs(book, has, first, slot, do, is_model, st, "c_ref", "c_cnt")

    @staticmethod
    def _refs(book, has, first, slot, do, is_model, st, ref_key, cnt_key):
        """The model's MNRL refresh (bID == 1, :1388-1398) or the cache's
        referred / continuous counts (:1401-1418). Returns (book, ref, cnt)."""
        K = book["mnrl"].shape[0]
        ks = _kidx(K, book["n"])
        if is_model:
            active = ks < book["n"]
            neg = book["total"][None] - book["last"] + book["first"] - 1
            book["mnrl"] = torch.where(active & do[None], torch.maximum(book["mnrl"], neg), book["mnrl"])
            return book, torch.where(do, -1, st[ref_key]), st[cnt_key]
        book["mnrl"] = torch.where((ks == slot) & (do & ~has)[None], 0, book["mnrl"])
        new_idx = torch.where(has, first, slot)
        same = has & (first == st[ref_key])
        cnt = torch.where(do, torch.where(same, st[cnt_key] + 1, 1), st[cnt_key])
        return book, torch.where(do, new_idx, st[ref_key]), cnt

    def _learn_model(self, st, diffs, xyz_f, lr, do, clear_num=None):
        """Both model books constructed on ``do`` pixels (then cleared
        with ``clear_num``, if given)."""
        RH, RW = do.shape
        do6 = do.expand((NN, RH, RW))
        st["tmodel"], st["t_ref"], st["t_cnt"] = self._t_construct(st["tmodel"], diffs, lr, do6, True, st)
        st["cmodel"], st["c_ref"], st["c_cnt"] = self._c_construct(st["cmodel"], xyz_f, lr, do, True, st)
        if clear_num is not None:
            st["tmodel"] = self._clear(st["tmodel"], clear_num, do6)
            st["cmodel"] = self._clear(st["cmodel"], clear_num, do)

    # ---------------- step ----------------------------------------------------
    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame. ``use_kernels=False`` takes the plain labelling (the
        boxes and Canny's hysteresis) on the card too."""
        cfg = self.config
        RH, RW = cfg.reducedHeight, cfg.reducedWidth
        f3 = frame if frame.ndim == 3 else frame[..., None].expand(*frame.shape, 3)
        h, w = f3.shape[:2]
        dev = frame.device
        t = int(state["t"])  # the branches' one synchronisation

        xyz, small_bgr = self._preprocess(f3)
        diffs = self._tex_diffs(xyz[..., 2].to(torch.float32))
        xyz_f = xyz.to(torch.float32)
        inset = torch.zeros((RH, RW), dtype=torch.bool, device=dev)
        inset[RADIUS : RH - RADIUS, RADIUS : RW - RADIUS] = True
        st = dict(state)

        if t <= cfg.trainingPeriod:
            self._learn_model(st, diffs, xyz_f, cfg.learningRate * 4, inset)
            if t == cfg.trainingPeriod:
                every = torch.ones((RH, RW), dtype=torch.bool, device=dev)
                st["tmodel"] = self._clear(st["tmodel"], cfg.trainingPeriod, every.expand((NN, RH, RW)))
                st["cmodel"] = self._clear(st["cmodel"], cfg.trainingPeriod, every)
                st["t"] = st["t"] + 1  # the extra g_iFrameCount++ (:305-310)
            fg = torch.zeros((h, w), dtype=torch.uint8, device=dev)
        else:
            fg = self._detect(st, diffs, xyz_f, small_bgr, inset, h, w, use_kernels)
        st["t"] = st["t"] + 1
        return st, fg, torch.zeros(frame.shape, dtype=torch.uint8, device=dev)

    def _landmark(self, st, diffs, xyz_f, inset):
        """CreateLandmarkArray_Par (:434-503): u8 0 / 125 / 255."""
        cfg = self.config
        tb, cb = st["tmodel"], st["cmodel"]
        K = cfg.modelCapacity
        act = _kidx(K, tb["n"]) < tb["n"]
        d = diffs[None]
        band = cfg.textureTrainVolRange + 5.0  # (mean ∓ 15) ∓ 5, folded
        matched = ((tb["mean"] + (-band) <= d) & (d <= tb["mean"] + band) & act).any(dim=0)
        conf = 1.0 - matched.sum(dim=0, dtype=torch.int32).to(torch.float32) * _INV_NN
        conf = torch.where(inset, conf, 0.0)
        tex_fg = conf > float(np.float32(cfg.T_ModelThreshold / float(NN)))
        # XLA:CPU sums the K·NN terms in row-major order
        back_sum = sequential_sum(torch.where(act, tb["mean"], 0.0).reshape((-1,) + tb["mean"].shape[2:]), 0)
        back_cnt = torch.clamp(act.sum(dim=(0, 1), dtype=torch.int32), min=1)
        back_amt = back_sum / back_cnt.to(torch.float32)
        input_amt = sequential_sum(diffs.abs(), 0)
        textureless = (back_amt < 50) & (input_amt < 50)
        rng = float(cfg.colorTrainVolRange + 10)
        c_act = _kidx(K, cb["n"]) < cb["n"]
        px = xyz_f[None]
        c_match = (((cb["mean"] + (-rng) <= px) & (px <= cb["mean"] + rng)).all(dim=-1) & c_act).any(dim=0)
        landmark = torch.where(tex_fg, 255, torch.where(textureless & ~c_match, 255,
                                                         torch.where(textureless & c_match, 125, 0)))
        return torch.where(inset, landmark, 0).to(torch.uint8)

    @staticmethod
    def _ghosts(small_bgr, fore, box_excl, valid, use_kernels):
        """EvaluateGhostRegion (:971-1050): [MAX_BOXES] bool, a valid box
        whose candidate-map edges lie more than 10 px (the 0.9 quantile, in
        count form against a 12-step chamfer field) from the frame's edges."""
        RH, RW = fore.shape
        frame_edges = canny(bgr2gray_u8(small_bgr), 100, 150, use_kernels) > 0
        fore_edges = canny(fore, 100, 150, use_kernels) > 0
        d = torch.where(frame_edges, 0.0, _INF)
        for _ in range(12):  # 3-4 chamfer distance to the frame's edges
            pd = F.pad(d, (1, 1, 1, 1), value=_INF)
            best = d
            for dy, dx, cst in _CHAMFER:
                best = torch.minimum(best, pd[1 + dy : 1 + dy + RH, 1 + dx : 1 + dx + RW] + cst)
            d = best
        fe = fore_edges[None] & box_excl
        nm = fe.sum(dim=(1, 2), dtype=torch.int32)
        ni = (frame_edges[None] & box_excl).sum(dim=(1, 2), dtype=torch.int32)
        close = (fe & (d[None] <= 10.0)).sum(dim=(1, 2), dtype=torch.int32)
        qidx = torch.minimum((0.9 * nm.to(torch.float32)).to(torch.int32), torch.clamp(nm - 1, min=0))
        ghost = torch.where((nm > 0) & (ni > 0), close <= qidx,
                            torch.where((nm == 0) & (ni > 0), ni > 10, (nm > 0) & (ni == 0) & (nm > 10)))
        return ghost & valid

    def _detect(self, st, diffs, xyz_f, small_bgr, inset, h, w, use_kernels):
        cfg = self.config
        RH, RW = cfg.reducedHeight, cfg.reducedWidth
        dev = diffs.device
        landmark = self._landmark(st, diffs, xyz_f, inset)

        # morphology: 5×5 count of 255s >= 12 (:671-716)
        on = F.pad((landmark == 255).to(torch.int32), (2, 2, 2, 2))
        rows = on[0:RH]
        for dy in range(1, 5):
            rows = rows + on[dy : dy + RH]
        cnt5 = rows[:, 0:RW]
        for dx in range(1, 5):
            cnt5 = cnt5 + rows[:, dx : dx + RW]
        fore = torch.where(inset & (cnt5 >= 12), 255, 0).to(torch.uint8)

        # boxes (4-connectivity labelling, :720-805; margins :835-852)
        blobs = extract_blobs(fore, MAX_BOXES, 4, use_kernels)
        bw, bh = RW // 80, RH // 60
        left = torch.clamp(blobs.x0 - bw, RADIUS, RW - RADIUS - 1)
        right = torch.clamp(blobs.x1 + bw, max=RW - RADIUS - 1)
        upper = torch.clamp(blobs.y0 - bh, RADIUS, RH - RADIUS - 1)
        bottom = torch.clamp(blobs.y1 + bh, max=RH - RADIUS - 1)
        exists = blobs.area > 0
        bwid, bhei = right - left, bottom - upper
        valid = exists & (bwid >= 5) & (bwid <= RW) & (bhei >= 5) & (bhei <= RH)

        yy = torch.arange(RH, device=dev)[None, :, None]
        xx = torch.arange(RW, device=dev)[None, None, :]
        up, bo, le, ri = (v[:, None, None] for v in (upper, bottom, left, right))
        box_excl = (yy >= up) & (yy < bo) & (xx >= le) & (xx < ri)  # the ghost / removal loops (:1007-1014)
        ghost = self._ghosts(small_bgr, fore, box_excl, valid, use_kernels)
        ghost_px = (box_excl & ghost[:, None, None]).any(dim=0)
        valid = valid & ~ghost

        # ghost pixels: extra model learning (:1031-1046)
        lr = cfg.learningRate
        self._learn_model(st, diffs, xyz_f, lr, ghost_px, cfg.backClearPeriod)
        # erase the invalid boxes' 255s (:1117-1134)
        invalid_px = (box_excl & (exists & ~valid)[:, None, None]).any(dim=0)
        fore = torch.where(invalid_px & (fore == 255), 0, fore).to(torch.uint8)

        # UpdateModel_Par (:364-431)
        box_incl = (yy >= up) & (yy <= bo) & (xx >= le) & (xx <= ri)
        in_valid_box = (box_incl & valid[:, None, None]).any(dim=0)
        upd_bg = inset & ~in_valid_box
        upd_cache = inset & in_valid_box
        self._learn_model(st, diffs, xyz_f, lr, upd_bg, cfg.backClearPeriod)
        if cfg.absorptionEnable:
            uc6 = upd_cache.expand((NN, RH, RW))
            st["tcache"], st["t_ref"], st["t_cnt"] = self._t_construct(st["tcache"], diffs, lr, uc6, False, st)
            st["ccache"], st["c_ref"], st["c_cnt"] = self._c_construct(st["ccache"], xyz_f, lr, upd_cache, False, st)
            st["tmodel"], st["tcache"] = self._absorb(st["tmodel"], st["tcache"], st["t_ref"], st["t_cnt"],
                                                      cfg.absorptionPeriod, uc6)
            st["cmodel"], st["ccache"] = self._absorb(st["cmodel"], st["ccache"], st["c_ref"], st["c_cnt"],
                                                      cfg.absorptionPeriod, upd_cache)
            lm_fg = landmark == 255
            st["tcache"] = self._cache_clear(st["tcache"], lm_fg.expand((NN, RH, RW)), st["t_ref"], 10,
                                             inset.expand((NN, RH, RW)))
            st["ccache"] = self._cache_clear(st["ccache"], lm_fg, st["c_ref"], 10, inset)

        # enlarge (GetForegroundMap -> cvResize bilinear, :1137-1186)
        out = resize_bilinear(fore.to(torch.float32), (h, w), use_kernels)
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
