"""Type-2 fuzzy GMM family (ustc types 17-20), counterpart of
``tracking_tpu/bgs/t2f.py``: T2FGMM_UM / T2FGMM_UV (``tb/T2FGMM.cpp:105-258``)
and T2FMRF_UM / T2FMRF_UV (``tb/T2FMRF.cpp:132-398``).

The Grimson GMM skeleton of ``bgs/gmm.py`` (mode-major banks, first-match
prefix masks, stable odd-even sorts by significance w / sigma) with the
Gaussian distance replaced by a type-2 fuzzy membership bound per channel,
``dist = sum_c H_c^2``:

- UM (uncertain mean): ``H = 2 km |d| / var`` outside ``mu +- km var``,
  else ``d^2 / (2 var^2) + km |d| / var + km^2 / 2`` (``var`` is the
  variance, not sigma: the reference's quirk);
- UV (uncertain variance): ``H = (1 / kv^2 - kv^2) d^2 / (2 var)``.

Quirks kept: the matched mode's mean moves by ``-k |d|`` (always down);
the weight prune never fires; the background is mode 0's mean after the
sort. The emitted mask is the high-threshold one (2 x threshold).

T2FMRF adds the per-pixel two-state HMM whose transition row of the
current hidden state moves toward the low-threshold label and is
renormalised (true divisions by device tensors). ``applyMRF=True``
smooths the emitted mask with :func:`tracking_tpu_torch.ops.mrf.icm_relax`
from frame 10 on (the JAX package's capability option; the reference
discards its smoothed mask). The JAX package has no Pallas code for these
models, so they are plain torch on every device.
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import State, StepResult
from tracking_tpu_torch.bgs.gmm import (
    _EPS, _first_match, _full, _GMMBase, _index_sum, _new_mode, _normalize, _significance, _sort_modes,
    _stack_state, _to_planes,
)
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops.consensus import recip
from tracking_tpu_torch.ops.mrf import icm_relax

BG_THRESHOLD = 0.75  # T2FGMM.cpp:73
INIT_VAR = 36.0  # T2FGMM.cpp:76


def _membership_dist(planes, mu_k, var_k, um: bool, km: float, kv: float):
    """sum_c H_c^2 for one mode (T2FGMM.cpp:157-182), in channel order."""
    terms = []
    for ci, p in enumerate(planes):
        if um:
            d = (mu_k[ci] - p).abs()
            band = var_k * km
            outside = (p < mu_k[ci] - band) | (p > mu_k[ci] + band)
            far = d * (2.0 * km) / var_k
            near = d * d / (var_k * 2.0 * var_k) + d * km / var_k + 0.5 * km * km
            h = torch.where(outside, far, near)
        else:
            d = p - mu_k[ci]
            h = d * (1.0 / (kv * kv) - kv * kv) * d / (var_k * 2.0)
        terms.append(h * h)
    return _index_sum(terms)


@dataclasses.dataclass(frozen=True)
class T2FGMMConfig(BGSConfig):
    threshold: float = 9.0
    alpha: float = 0.01
    km: float = 1.5
    kv: float = 0.6
    gaussians: int = 3
    showOutput: bool = True


class _T2FGMMBase(_GMMBase):
    """The GMM state layout of ``bgs/gmm.py`` (``_GMMBase.init``)."""

    Config = T2FGMMConfig
    UM: bool = True

    def _subtract(self, state, frame):
        """``T2FGMM::SubtractPixel`` over whole maps: returns (w, var, mu
        stacked, n, bg_low, bg_high, bg_u8)."""
        cfg = self.config
        K, alpha = cfg.gaussians, cfg.alpha
        planes = _to_planes(frame)
        C = len(planes)
        dev = planes[0].device
        eps, a_t = _full(_EPS, dev), _full(alpha, dev)
        w = list(state["w"].unbind(0))
        var = list(state["var"].unbind(0))
        mu = [list(state["mu"][k].unbind(0)) for k in range(K)]
        n = state["n"]
        active = [n > k for k in range(K)]

        excl = torch.zeros_like(w[0])  # exclusive prefix of the old weights
        is_bg = []
        for k in range(K):
            is_bg.append((excl < BG_THRESHOLD) & active[k])
            excl = excl + w[k]

        dist = [_membership_dist(planes, mu[k], var[k], self.UM, cfg.km, cfg.kv) for k in range(K)]
        match = [(dist[k] < var[k] * cfg.threshold) & active[k] for k in range(K)]
        has_match, is_match, considered = _first_match(match)
        # the high check visits the modes up to the first match
        bg_high = torch.zeros_like(has_match)
        bg_low = torch.zeros_like(has_match)
        for k in range(K):
            cons_k = torch.where(has_match, considered[k], True) & active[k]
            bg_high = bg_high | ((dist[k] < var[k] * (2.0 * cfg.threshold)) & is_bg[k] & cons_k)
            bg_low = bg_low | (is_match[k] & is_bg[k])

        w1, var1 = [], []
        for k in range(K):
            kk = a_t / torch.maximum(w[k], eps)
            wk = torch.where(active[k], w[k] * (1.0 - alpha), w[k])
            w1.append(torch.where(is_match[k], wk + alpha, wk))
            for ci in range(C):  # the mean moves by -k |d| whichever side the pixel is on
                mu[k][ci] = torch.where(is_match[k], mu[k][ci] - kk * (mu[k][ci] - planes[ci]).abs(), mu[k][ci])
            var1.append(torch.where(is_match[k], torch.clamp(var[k] + kk * (dist[k] - var[k]), 4.0, 5.0 * INIT_VAR),
                                    var[k]))
        w1 = _normalize(w1, active, eps)
        w1, var1, mu = _sort_modes(_significance(w1, var1, active, eps), w1, var1, mu)

        n1, w2, var2 = _new_mode(n, has_match, K, w1, var1, mu, planes, a_t, INIT_VAR)
        active2 = [n1 > k for k in range(K)]
        w2 = _normalize(w2, active2, eps)
        w2, var2, mu = _sort_modes(_significance(w2, var2, active2, eps), w2, var2, mu)

        bg_u8 = torch.stack([mu[0][ci] for ci in range(C)], dim=-1).to(torch.uint8)
        if frame.ndim == 2:
            bg_u8 = bg_u8[..., 0]
        ws, vs, ms = _stack_state(w2, var2, mu)
        return ws, vs, ms, n1.to(torch.int32), bg_low, bg_high, bg_u8

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        w, var, mu, n, _, bg_high, bg_u8 = self._subtract(state, frame)
        fg = torch.where(bg_high, 0, 255).to(torch.uint8)
        return {"t": state["t"] + 1, "w": w, "var": var, "mu": mu, "n": n}, fg, bg_u8


@register("T2FGMM_UM", type_id=17, aliases=("t2fgmm-um",))
class T2FGMM_UM(_T2FGMMBase):
    UM = True


@register("T2FGMM_UV", type_id=18, aliases=("t2fgmm-uv",))
class T2FGMM_UV(_T2FGMMBase):
    UM = False


@dataclasses.dataclass(frozen=True)
class T2FMRFConfig(BGSConfig):
    threshold: float = 9.0
    alpha: float = 0.01
    km: float = 2.0
    kv: float = 0.9
    gaussians: int = 3
    showOutput: bool = True
    # the JAX package's option: apply the MRF-ICM smoothing the reference
    # computes and discards (off = the reference's output)
    applyMRF: bool = False


class _T2FMRFBase(_T2FGMMBase):
    Config = T2FMRFConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        st = super().init(h, w, c, device)
        # HMM init (T2FMRF.cpp:117-124): background, Ab2b .7, Ab2f .3, Af2b .4, Af2f .6
        st["hmm_fg"] = torch.zeros((h, w), dtype=torch.bool, device=device)
        for k, v in (("Ab2b", 0.7), ("Ab2f", 0.3), ("Af2b", 0.4), ("Af2f", 0.6)):
            st[k] = torch.full((h, w), v, dtype=torch.float32, device=device)
        st["old_labeling"] = torch.zeros((h, w), dtype=torch.uint8, device=device)
        return st

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        cfg = self.config
        alpha = cfg.alpha
        w, var, mu, n, bg_low, bg_high, bg_u8 = self._subtract(state, frame)
        low_mask = torch.where(bg_low, 0, 255).to(torch.uint8)
        fg = torch.where(bg_high, 0, 255).to(torch.uint8)

        # the transition row of the current hidden state moves toward the
        # new label, then renormalises (T2FMRF.cpp:341-398)
        eps = _full(_EPS, w.device)
        was_fg = state["hmm_fg"]
        to_fg = ~bg_low
        d_b2b = torch.where(to_fg, 0.0, alpha)
        d_b2f = torch.where(to_fg, alpha, 0.0)
        Ab2b = torch.where(~was_fg, state["Ab2b"] * (1 - alpha) + d_b2b, state["Ab2b"])
        Ab2f = torch.where(~was_fg, state["Ab2f"] * (1 - alpha) + d_b2f, state["Ab2f"])
        Af2b = torch.where(was_fg, state["Af2b"] * (1 - alpha) + d_b2b, state["Af2b"])
        Af2f = torch.where(was_fg, state["Af2f"] * (1 - alpha) + d_b2f, state["Af2f"])
        zb = torch.maximum(Ab2b + Ab2f, eps)
        zf = torch.maximum(Af2b + Af2f, eps)
        Ab2b, Ab2f = Ab2b / zb, Ab2f / zb
        Af2b, Af2f = Af2b / zf, Af2f / zf

        if cfg.applyMRF:
            C = mu.shape[1]
            f3 = (frame if frame.ndim == 3 else frame[..., None]).to(torch.float32)
            mu0 = _index_sum(list(mu[0].unbind(0))) * recip(C)  # mode 0's mean over the channels
            gray = _index_sum(list(f3.unbind(-1))) * recip(C)
            one = torch.ones((), dtype=torch.float32, device=w.device)
            fg = icm_relax(fg, gray, mu0, torch.maximum(var[0], one), state["old_labeling"],
                           enabled=state["t"] >= 10)

        new_state = {
            "t": state["t"] + 1, "w": w, "var": var, "mu": mu, "n": n,
            "hmm_fg": to_fg, "Ab2b": Ab2b, "Ab2f": Ab2f, "Af2b": Af2b, "Af2f": Af2f, "old_labeling": low_mask,
        }
        return new_state, fg, bg_u8


@register("T2FMRF_UM", type_id=19, aliases=("t2fmrf-um",))
class T2FMRF_UM(_T2FMRFBase):
    UM = True


@register("T2FMRF_UV", type_id=20, aliases=("t2fmrf-uv",))
class T2FMRF_UV(_T2FMRFBase):
    UM = False
