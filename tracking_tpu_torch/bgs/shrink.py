"""shrinkBGS and the MyBGS template, counterpart of ``tracking_tpu/bgs/shrink.py``.

shrinkBGS (``ustc_src/shrinkBGS/shrinkbgs.{h,cpp}``, SURVEY §2.9): a
30-sample colour model with a per-pixel distance threshold. A sample is
good where every channel lies within the box L1Threshold = (10, 5, 5) and
the L1 distance within the pixel's threshold (its integer part); fewer than
2 good samples make the raw mask foreground, and background pixels pull
their threshold toward the best distance at a global rate adapted ±0.01 in
[0, 0.1] from the raw-versus-median noise. The pure mask is the raw mask's
5×5 median. Stable background writes a random slot and, with probability
1/5, spreads to a random 3×3 neighbour; pixels where raw and pure differ
retest with relaxed thresholds (+5) first; during the first 30 frames pure
background also inserts with probability 1/2. The first frame seeds the
model from gaussian-weighted nearby positions and emits no mask.

The random draws are the JAX package's (``jax.random.split`` and
``randint`` on ``PRNGKey(7)``, ``ops/rng.py``), so masks and samples equal
its bit for bit. The sample walk is a per-sample prefix count, the same
counts and minima as the reference's ordered scan. Plain torch: the JAX
package has no Pallas code for it.

MyBGS (``package_bgs/my/MyBGS.cpp``): the write-your-own template,
|frame − previous frame| in grey over 15.
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.bgs.lbsp_family import _NB3, _pick_neighbor, _refresh_samples
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops import rng
from tracking_tpu_torch.ops.color import bgr2gray_u8
from tracking_tpu_torch.ops.consensus import recip
from tracking_tpu_torch.ops.filters import binary_median_blur

_RMAX = 1 << 30
L1_THRESHOLD = (10, 5, 5)  # shrinkbgs.cpp:12-14
LEARN_STEP = 5  # img_backgroundLearnStep fill (init(), :237)


@register("MyBGS", aliases=("mybgs",))
class MyBGS(BGSAlgorithm):
    """Frame-difference template (not in FrameProcessor either)."""

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        c = max(c, 1)
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "prev": torch.zeros((h, w, c) if c > 1 else (h, w), dtype=torch.uint8, device=device),
        }

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        prev = self._first_frame_select(state["t"], state["prev"], frame)
        diff = (frame.to(torch.int16) - prev.to(torch.int16)).abs()
        gray = bgr2gray_u8(diff.to(torch.uint8)) if frame.ndim == 3 else diff
        fg = torch.where(gray > 15, 255, 0).to(torch.uint8)
        return {"t": state["t"] + 1, "prev": frame}, fg, prev


@dataclasses.dataclass(frozen=True)
class ShrinkBGSConfig(BGSConfig):
    # the XML exposes enableThreshold / threshold / showOutput (unused by the
    # algorithm, shrinkbgs.h:92-95); the rest are the reference's constants
    enableThreshold: bool = True
    threshold: int = 15
    showOutput: bool = True
    SampleNum: int = 30
    requiredBGSamples: int = 2
    foregroundAcceptNum: int = 2


def _planes3(frame: torch.Tensor):
    """[H, W, 3] or grey [H, W] u8 -> 3 planes (grey repeated)."""
    if frame.ndim == 2:
        return (frame,) * 3
    return tuple(frame[..., c] for c in range(3))


def _good(planes, samples, thr_i, slack: int) -> torch.Tensor:
    """[N, H, W] bool: every channel within L1Threshold + ``slack`` and the
    L1 distance within ``thr_i``; also returns the distances."""
    box_ok, tot = None, None
    for c in range(3):
        d = (samples[c].to(torch.int32) - planes[c].to(torch.int32)[None]).abs()
        ok = d <= L1_THRESHOLD[c] + slack
        box_ok = ok if box_ok is None else box_ok & ok
        tot = d if tot is None else tot + d
    return box_ok & (tot <= thr_i[None]), tot


def _slot_mask(upd: torch.Tensor, slot: torch.Tensor, n: int) -> torch.Tensor:
    return upd[None] & (slot[None] == torch.arange(n, dtype=slot.dtype, device=slot.device)[:, None, None])


@register("shrinkBGS", aliases=("shrink",))
class ShrinkBGS(BGSAlgorithm):
    Config = ShrinkBGSConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        N = self.config.SampleNum
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "key": rng.prng_key(7, device=device),
            "samples": tuple(torch.zeros((N, h, w), dtype=torch.uint8, device=device) for _ in range(3)),
            "dist_thr": torch.full((h, w), 15.0, dtype=torch.float32, device=device),
            "lr": torch.full((), 0.05, dtype=torch.float32, device=device),
        }

    def warm_start(self, state: State, frame: torch.Tensor) -> State:
        """refreshModel(1.0, force): every slot from a gaussian-weighted
        nearby position (``shrinkbgs.cpp:193-230``)."""
        N = self.config.SampleNum
        planes = _planes3(frame)
        h, w = planes[0].shape
        key, sub = rng.split(state["key"], 2)
        samples, _ = _refresh_samples(
            sub, N, N, 0, planes, (), torch.ones((h, w), dtype=torch.bool, device=frame.device), state["samples"], (),
        )
        return dict(state, key=key, samples=samples)

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``shrink.py:112-230``; ``use_kernels``: the common step
        signature, no kernel)."""
        cfg = self.config
        N, req = cfg.SampleNum, cfg.requiredBGSamples
        planes = _planes3(frame)
        h, w = planes[0].shape
        dev = frame.device
        t = state["t"]
        started = t > 0
        keys = rng.split(state["key"], 8)
        samples = state["samples"]

        # consensus (getRawForegroundMask): the first ``req`` good samples
        # in slot order count, and the least distance among them
        dist_thr = state["dist_thr"]
        thr_i = dist_thr.to(torch.int32)  # the (size_t) cast truncates
        good, tot = _good(planes, samples, thr_i, 0)
        gi = good.to(torch.int32)
        live = good & (torch.cumsum(gi, dim=0) - gi < req)
        dmin = torch.where(live, tot.to(torch.float32), torch.inf).amin(dim=0)
        dmin = torch.minimum(dist_thr, dmin)
        is_fg = gi.sum(dim=0) < req
        raw = torch.where(is_fg & started, 255, 0).to(torch.uint8)
        lr = state["lr"]
        dist_thr = torch.where(~is_fg & started, dist_thr * (1 - lr) + lr * dmin, dist_thr)
        pure = binary_median_blur(raw, 5)

        # updates (none on frame 0)
        raw_bg, pure_bg = raw == 0, pure == 0
        stable_bg = raw_bg & pure_bg & started
        xor_bg = (raw_bg != pure_bg) & started
        # relaxed retest where raw and pure differ (learnStepCheck, :358-393)
        relaxed, _ = _good(planes, samples, thr_i + 3 * LEARN_STEP, LEARN_STEP)
        xor_ok = xor_bg & (relaxed.to(torch.int32).sum(dim=0) >= req)

        # self-update (learningRateNum == 1: always) and the bootstrap accept
        # of the first SampleNum frames
        slot_self = rng.randint(keys[2], (h, w), 0, N)
        boot = pure_bg & started & (t < N) & (rng.randint(keys[3], (h, w), 0, _RMAX) % cfg.foregroundAcceptNum == 0)
        m1 = _slot_mask(stable_bg | xor_ok | boot, slot_self, N)
        samples = tuple(torch.where(m1, planes[c][None], samples[c]) for c in range(3))

        # neighbour spread with probability 1/5 from stable background
        src_fire = stable_bg & (rng.randint(keys[4], (h, w), 0, _RMAX) % 5 == 0)
        o_idx = rng.randint(keys[5], (h, w), 0, len(_NB3))
        picked = _pick_neighbor(o_idx, _NB3, (src_fire,) + planes)
        mn = _slot_mask(picked[0], rng.randint(keys[6], (h, w), 0, N), N)
        samples = tuple(torch.where(mn, picked[1 + c][None], samples[c]) for c in range(3))

        # global learning-rate adaptation (updateDistanceThreshold, :483-506):
        # a division of two device values
        noise = ((raw > 0) & pure_bg).sum(dtype=torch.int32)
        bg_area = pure_bg.sum(dtype=torch.int32).clamp(min=1)
        rate = noise.to(torch.float32) / bg_area.to(torch.float32)
        new_lr = torch.where(rate < 0.05, (lr + 0.01).clamp(max=0.1),
                             torch.where(rate > 0.1, (lr - 0.01).clamp(min=0.0), lr))
        lr = torch.where(started, new_lr, lr)

        # the mean of the N slots: an exact sum times f32(1/N), as XLA
        # rewrites the division by a constant, truncated to u8
        bg = torch.stack([(s.sum(dim=0, dtype=torch.int32).to(torch.float32) * recip(N)).to(torch.uint8)
                          for s in samples], dim=-1)
        if frame.ndim == 2:
            bg = bg[..., 0]
        new_state = {"t": t + 1, "key": keys[0], "samples": samples, "dist_thr": dist_thr, "lr": lr}
        return new_state, raw, bg
