"""DPPratiMediodBGS (ustc type 14, Prati / Cucchiara's temporal mediod),
counterpart of ``tracking_tpu/bgs/prati_mediod.py``.

Every samplingRate-th frame enters a ring buffer of historySize samples;
each buffered sample carries the sum of its L∞ distances to the others,
and the mediod (the sample of least sum) is the background
(``dp/PratiMediodBGS.cpp:51-271``). Masks: the L∞ distance to the mediod
against a low and a high threshold, joined by 8-connected hysteresis (low
foreground kept next to high foreground, the border forced to background).
The reference's quirks stay: the replacement adds the new frame's distance
to the departing sample before overwriting it, and the tracked mediod is
not re-examined after that overwrite (``:100-106``, ``:131-168``).

All of it is integer arithmetic, so the port is exact on every device. The
JAX package gates the sampled update behind ``lax.cond`` on ``t``; reading
``t`` on the host would synchronise the card every frame, so this step
computes the sampled update on every frame and selects it with
``torch.where``. The ring slot ``pos`` is read with ``index_select`` on the
0-d device index, and the mediod is picked with a gather of the argmin
slot (exact: a selection, no arithmetic). The JAX package has no Pallas
code for this model, so it is plain torch on every device.
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops.morphology import dilate

_I32_MAX = 2**31 - 1
# distance sums stay below S · 255 < 2^13: a masked slot sorts last at 2^20
_MASKED = 1 << 20


def _channels(frame: torch.Tensor):
    if frame.ndim == 2:
        return (frame,)
    return tuple(frame[..., c] for c in range(frame.shape[-1]))


def _linf(a_channels, b_channels) -> torch.Tensor:
    """max_c |a_c − b_c| as int32 (broadcasting)."""
    d = None
    for a, b in zip(a_channels, b_channels):
        di = (a.to(torch.int32) - b.to(torch.int32)).abs()
        d = di if d is None else torch.maximum(d, di)
    return d


@dataclasses.dataclass(frozen=True)
class PratiMediodConfig(BGSConfig):
    threshold: int = 30
    samplingRate: int = 5
    historySize: int = 16
    weight: int = 5
    showOutput: bool = True


@register("DPPratiMediodBGS", type_id=14, aliases=("prati-mediod",))
class DPPratiMediod(BGSAlgorithm):
    Config = PratiMediodConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        c = max(c, 1)
        S = self.config.historySize

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        return {
            "t": zeros((), torch.int32),
            "count": zeros((), torch.int32),  # buffered samples
            "pos": zeros((), torch.int32),  # ring position
            "buf": tuple(zeros((S, h, w), torch.uint8) for _ in range(c)),
            "dist": zeros((S, h, w), torch.int32),
            "median": tuple(zeros((h, w), torch.uint8) for _ in range(c)),
            "median_dist": torch.full((h, w), _I32_MAX, dtype=torch.int32, device=device),
        }

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels`` is accepted for the common step
        signature; this algorithm has no kernel)."""
        cfg = self.config
        S = cfg.historySize
        src = _channels(frame)
        t = state["t"]

        # Subtract: masks from the last mediod (:248-271)
        dist_to_med = _linf(src, state["median"])
        low_fg = dist_to_med > cfg.threshold
        high_fg = dist_to_med > 2 * cfg.threshold
        near_high = dilate(torch.where(high_fg, 255, 0).to(torch.uint8), 3) > 0
        combined = high_fg | (low_fg & near_high)
        combined[0, :] = False
        combined[-1, :] = False
        combined[:, 0] = False
        combined[:, -1] = False
        fg = torch.where(combined & (t >= S), 255, 0).to(torch.uint8)

        # the sampled update (:69-129), selected where t % samplingRate == 0
        count, pos, buf, dist = state["count"], state["pos"], state["buf"], state["dist"]
        sidx = torch.arange(S, dtype=torch.int32, device=t.device)[:, None, None]
        filling = count < S
        d_new = _linf(buf, tuple(s[None] for s in src))  # [S, H, W]
        # filling: append at slot `count`
        in_buf = sidx < count
        d_in = torch.where(in_buf, d_new, 0)
        new_sum_fill = d_in.sum(dim=0, dtype=torch.int32)
        fill_slot = sidx == count
        fill_dist = torch.where(fill_slot, new_sum_fill[None], dist + d_in)
        # replacing: the sample at `pos` departs
        at_pos = pos.reshape(1).long()
        old = tuple(b.index_select(0, at_pos) for b in buf)
        rep_dist = dist - _linf(buf, old) + d_new
        new_sum_rep = d_new.sum(dim=0, dtype=torch.int32)
        rep_slot = sidx == pos
        sel_dist = torch.where(filling, fill_dist, torch.where(rep_slot, new_sum_rep[None], rep_dist))
        new_slot = torch.where(filling, fill_slot, rep_slot)
        sel_buf = tuple(torch.where(new_slot, s[None], b) for s, b in zip(src, buf))
        # the mediod among the updated sums: filling, the slots below the new
        # count; replacing, the sums before the overwrite of `pos`
        med_masked = torch.where(filling, torch.where(sidx < count + 1, fill_dist, _MASKED), rep_dist)
        key = (med_masked * S + sidx).amin(dim=0)  # the first slot of least sum
        slot = (key % S).long()[None]
        med_min = key // S
        med_px = tuple(b.gather(0, slot)[0] for b in sel_buf)
        new_sum = torch.where(filling, new_sum_fill, new_sum_rep)
        new_wins = new_sum < med_min  # the new point may beat the mediod (:163-168)
        med_px = tuple(torch.where(new_wins, s, m) for s, m in zip(src, med_px))
        med_min = torch.where(new_wins, new_sum, med_min)

        sample = (t % cfg.samplingRate) == 0
        out = {
            "t": t + 1,
            "count": torch.where(sample & filling, count + 1, count),
            "pos": torch.where(sample, torch.where(filling, 0, (pos + 1) % S), pos).to(torch.int32),
            "buf": tuple(torch.where(sample, b, ob) for b, ob in zip(sel_buf, buf)),
            "dist": torch.where(sample, sel_dist, dist),
            "median": tuple(torch.where(sample, m, om) for m, om in zip(med_px, state["median"])),
            "median_dist": torch.where(sample, med_min, state["median_dist"]),
        }
        bg = out["median"][0] if frame.ndim == 2 else torch.stack(out["median"], dim=-1)
        return out, fg, bg
