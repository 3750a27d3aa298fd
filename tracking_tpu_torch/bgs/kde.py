"""KDE (ustc type 32, Elgammal's non-parametric kernel-density BGS),
counterpart of ``tracking_tpu/bgs/kde.py`` (wrapper ``ae/KDE.cpp`` over
``NPBGSubtractor.cpp`` / ``NPBGmodel.cpp`` / ``KernelTable.cpp``).

1. Frames 0 .. framesToLearn - 1 are stored (as colour ratios (s, g, r)
   when ``lUseColorRatiosFlag``) into a zeroed SequenceLength-deep sample
   ring; the mask is empty.
2. At t == framesToLearn, once: per pixel and channel a 20-bin histogram
   of the consecutive samples' absolute differences, its median, and
   sigma = max(1.04 (bin - (x2 - median) / (x2 - x1)), 0.5) quantised to
   80 kernel bins (or the fixed bin of sigma 1 without
   ``SDEstimationFlag``); each pixel keeps its bin's kernel constants.
3. Every later frame: the kernel density over the ring, c1n exp(c2 d^2)
   per channel (the colour-ratio path gates samples on channel 0's
   brightness and multiplies the two chromaticity kernels); p > th is
   background.
4. The pair update: every max(TimeWindowSize / SequenceLength, 2)-th
   frame once the 2-frame buffer is full, each pixel whose two buffered
   masks are background writes the buffered pair over ring slots qtop,
   qtop + 1 and patches its histogram with wrapping u8 counters; masks
   stuck FG for 500 frames are stored as background.

Float order as XLA:CPU runs the JAX code: ``255 / (b + g + r + 30)``
divides a device tensor; ``exp`` is XLA's (``ops/xla_math.exp``); the mean
over the ring sums runs of 32 samples in order, then the runs
(``ops/gmg.blocked_sum``), then takes the product by f32(1/S). The
reference's one-hot sums over the 80 kernel bins and the ring slots have
one nonzero term, so the port reads them with gathers.

The JAX package branches with ``lax.cond`` on the 0-d state (learning,
the one-time estimation, the pair update); the port reads those four
scalars on the host with one synchronisation a frame and runs only the
branch taken. The sample ring and the frame buffer update in place
(``step`` consumes its state). The JAX package has no Pallas code for this
model, so it is plain torch on every device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops import xla_math
from tracking_tpu_torch.ops.consensus import recip
from tracking_tpu_torch.ops.gmg import blocked_sum

SEGMAMIN, SEGMAMAX, SEGMABINS = 0.5, 36.5, 80  # NPBGSubtractor.h:67-70
HISTBINS = 20  # Abshistbins, NPBGSubtractor.cpp:325
PI = 3.14159  # KernelTable.cpp:52


def _kernel_tables():
    """Per sigma bin (C1 / norm, C2) so that kernel(bin, d) = c1n exp(c2 d^2),
    KernelLUTable's normalisation (KernelTable.cpp:88-109), in float64
    rounded to f32."""
    step = (SEGMAMAX - SEGMAMIN) / SEGMABINS
    sig = SEGMAMIN + step * np.arange(SEGMABINS)
    c1 = 1.0 / (np.sqrt(2 * PI) * sig)
    c2 = -1.0 / (2.0 * sig * sig)
    x = np.arange(256)
    norm = 2.0 * (c1[:, None] * np.exp(c2[:, None] * x * x)).sum(1) - c1
    return (c1 / norm).astype(np.float32), c2.astype(np.float32)


_C1N, _C2 = _kernel_tables()


def bgr_to_sngnrn(frame: torch.Tensor):
    """BGR2SnGnRn (NPBGSubtractor.cpp:64-93): (s, g-ratio, r-ratio) u8 planes."""
    b, g, r = (frame[..., i].to(torch.int32) for i in range(3))
    s = torch.full((), 255.0, dtype=torch.float32, device=frame.device) / (b + g + r + 30).to(torch.float32)
    r2 = ((g + 10).to(torch.float32) * s).to(torch.int32)
    r3 = ((r + 10).to(torch.float32) * s).to(torch.int32)
    return (((b + g + r) // 3).to(torch.uint8), torch.clamp(r2, max=255).to(torch.uint8),
            torch.clamp(r3, max=255).to(torch.uint8))


@dataclasses.dataclass(frozen=True)
class KDEConfig(BGSConfig):
    framesToLearn: int = 10
    SequenceLength: int = 50
    TimeWindowSize: int = 100
    SDEstimationFlag: bool = True
    lUseColorRatiosFlag: bool = True
    th: float = 10e-8
    alpha: float = 0.3
    showOutput: bool = True
    updateBG: bool = True  # reference reads this flag uninitialized


@register("KDE", type_id=32, aliases=("kde",))
class KDE(BGSAlgorithm):
    Config = KDEConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        cfg = self.config
        S = cfg.SequenceLength
        tb_len = max(cfg.TimeWindowSize // S, 2)
        c = max(c, 1)
        kw = dict(device=device)
        zero = lambda *shape, dtype=torch.uint8: torch.zeros(shape, dtype=dtype, **kw)  # noqa: E731
        return {
            "t": zero(dtype=torch.int32),
            "seq": tuple(zero(S, h, w) for _ in range(c)),
            # PixelQTop after the last learning AddFrame: the slot past the learned samples
            "qtop": torch.full((h, w), cfg.framesToLearn % S, dtype=torch.int32, **kw),
            "hist": tuple(zero(HISTBINS, h, w) for _ in range(c)),
            "c1n_px": tuple(zero(h, w, dtype=torch.float32) for _ in range(c)),
            "c2_px": tuple(zero(h, w, dtype=torch.float32) for _ in range(c)),
            "tb": tuple(zero(tb_len, h, w) for _ in range(c)),
            "tb_mask": zero(tb_len, h, w),
            "tb_top": zero(dtype=torch.int32),
            "tb_count": zero(dtype=torch.int32),
            "acc_mask": zero(h, w, dtype=torch.int32),
            "time_index": zero(dtype=torch.int32),
        }

    def _estimate(self, seq):
        """The absolute-difference histograms of the learned ring and the
        kernel constants of their sigma bins."""
        S = self.config.SequenceLength
        bins = torch.arange(HISTBINS, device=seq[0].device)[:, None, None, None]
        hist = []
        for ch in seq:
            a, b = ch[: S - 1].to(torch.int32), ch[1:S].to(torch.int32)
            diff = torch.clamp((a - b).abs(), max=HISTBINS - 1)
            hist.append((diff[None] == bins).sum(dim=1, dtype=torch.int32).to(torch.uint8))
        return (tuple(hist),) + self._sds_from_hist(hist)

    def _sds_from_hist(self, hist):
        S = self.config.SequenceLength
        median_count = ((S - 1) & 0xFF) // 2
        dev = hist[0].device
        c1n_tab, c2_tab = torch.from_numpy(_C1N).to(dev), torch.from_numpy(_C2).to(dev)
        c1n_px, c2_px = [], []
        for hc in hist:
            h = hc.to(torch.int32)
            cum = torch.zeros_like(h[0])
            found = torch.zeros(h.shape[1:], dtype=torch.bool, device=dev)
            med_bin, x2, hb = torch.zeros_like(h[0]), torch.zeros_like(h[0]), torch.zeros_like(h[0])
            for k in range(HISTBINS):
                cum = cum + h[k]
                hit = (cum >= median_count) & ~found
                med_bin = torch.where(hit, k, med_bin)
                x2 = torch.where(hit, cum, x2)
                hb = torch.where(hit, h[k], hb)
                found = found | hit
            x1 = x2 - hb
            v = (med_bin.to(torch.float32) - (x2 - median_count).to(torch.float32)
                 / torch.clamp((x2 - x1).to(torch.float32), min=1.0)) * 1.04
            v = torch.clamp(v, min=SEGMAMIN)
            factor = (SEGMABINS - 1) / (SEGMAMAX - SEGMAMIN)
            b = torch.where(v >= SEGMAMAX, SEGMABINS - 1, torch.floor((v - SEGMAMIN) * factor + 0.5).to(torch.int32))
            c1n_px.append(c1n_tab[b.long()])
            c2_px.append(c2_tab[b.long()])
        return tuple(c1n_px), tuple(c2_px)

    def _probability(self, img, seq, c1n_px, c2_px):
        cfg = self.config
        S = len(seq[0])

        def kern(ch):
            d = seq[ch].to(torch.float32) - img[ch].to(torch.float32)[None]
            return c1n_px[ch][None] * xla_math.exp(c2_px[ch][None] * d * d)

        if len(img) == 1:
            terms = kern(0)
        elif cfg.lUseColorRatiosFlag:  # the subset gate on channel 0
            beta = 3.0
            g0 = seq[0].to(torch.float32)
            near = g0 < beta / cfg.alpha
            x1 = torch.where(near, torch.trunc(g0 - beta), torch.trunc(g0 * (1 - cfg.alpha) + 0.5))
            x2 = torch.where(near, torch.trunc(g0 + beta), torch.trunc(g0 * (1 + cfg.alpha) + 0.5))
            x0 = img[0].to(torch.float32)[None]
            terms = torch.where((x1 < x0) & (x0 < x2), kern(1) * kern(2), 0.0)
        else:
            terms = kern(0) * kern(1) * kern(2)
        return blocked_sum(list(terms.unbind(0))) * recip(S)

    def _update_pairs(self, st, img, mask, top: int, do_pairs: bool):
        """The pair update (when ``do_pairs``) and the buffer store; ``top``
        is the buffer's write slot."""
        cfg = self.config
        S = cfg.SequenceLength
        tb_len = st["tb"][0].shape[0]
        nxt = (top + 1) % tb_len
        st = dict(st)
        if do_pairs:
            pix_ok = (st["tb_mask"][top] == 0) & (st["tb_mask"][nxt] == 0)
            q1 = st["qtop"].long()[None]
            q2 = (q1 + 1) % S
            hist = list(st["hist"])
            bins = torch.arange(HISTBINS, device=q1.device)[:, None, None]
            for ch, seq in enumerate(st["seq"]):
                f1, f2 = st["tb"][ch][top], st["tb"][ch][nxt]
                old1, old2 = seq.gather(0, q1)[0], seq.gather(0, q2)[0]
                seq.scatter_(0, q1, torch.where(pix_ok, f1, old1)[None])
                seq.scatter_(0, q2, torch.where(pix_ok, f2, old2)[None])
                if cfg.SDEstimationFlag:  # the wrapping u8 histogram patch
                    d_add = torch.clamp((f1.to(torch.int32) - f2.to(torch.int32)).abs(), max=HISTBINS - 1)
                    d_rem = torch.clamp((old1.to(torch.int32) - old2.to(torch.int32)).abs(), max=HISTBINS - 1)
                    delta = (d_add[None] == bins).to(torch.uint8) - (d_rem[None] == bins).to(torch.uint8)
                    hist[ch] = torch.where(pix_ok[None], hist[ch] + delta, hist[ch])
            st["hist"] = tuple(hist)
            st["qtop"] = torch.where(pix_ok, (st["qtop"] + 2) % S, st["qtop"])

        # stuck-FG suppression, then the frame and its mask into the buffer
        acc = torch.where(mask > 0, st["acc_mask"] + 1, 0).to(torch.int32)
        for ch in range(len(img)):
            st["tb"][ch][top] = img[ch]
        st["tb_mask"][top] = torch.where(acc > 500, 0, mask).to(torch.uint8)
        st["acc_mask"] = acc
        st["tb_top"] = torch.full_like(st["tb_top"], nxt)
        st["tb_count"] = st["tb_count"] + 1
        st["time_index"] = st["time_index"] + 1
        return st

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        cfg = self.config
        S = cfg.SequenceLength
        f3 = frame if frame.ndim == 3 else frame[..., None]
        if cfg.lUseColorRatiosFlag and f3.shape[-1] == 3:
            img = bgr_to_sngnrn(f3)
        else:
            img = tuple(f3[..., ch] for ch in range(f3.shape[-1]))
        # the branches' scalars, one synchronisation
        t, top, count, tindex = torch.stack(
            [state["t"], state["tb_top"], state["tb_count"], state["time_index"]]).tolist()
        st = dict(state, t=state["t"] + 1)
        bg = torch.zeros(frame.shape, dtype=torch.uint8, device=frame.device)
        if t < cfg.framesToLearn:
            for ch in range(len(img)):
                st["seq"][ch][t % S] = img[ch]
            return st, torch.zeros(frame.shape[:2], dtype=torch.uint8, device=frame.device), bg
        if t == cfg.framesToLearn:
            if cfg.SDEstimationFlag:
                st["hist"], st["c1n_px"], st["c2_px"] = self._estimate(st["seq"])
            else:
                b0 = int(((1.0 - SEGMAMIN) * SEGMABINS) / (SEGMAMAX - SEGMAMIN))
                st["c1n_px"] = tuple(torch.full_like(x, float(_C1N[b0])) for x in st["c1n_px"])
                st["c2_px"] = tuple(torch.full_like(x, float(_C2[b0])) for x in st["c2_px"])
        p = self._probability(img, st["seq"], st["c1n_px"], st["c2_px"])
        mask = torch.where(p > cfg.th, 0, 255).to(torch.uint8)
        if cfg.updateBG:
            tb_len = st["tb"][0].shape[0]
            do_pairs = tindex % max(cfg.TimeWindowSize // S, 2) == 0 and count >= tb_len
            st = self._update_pairs(st, img, mask, top, do_pairs)
        return st, mask, bg
