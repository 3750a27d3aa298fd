"""Per-pixel Gaussian-mixture BGS, counterpart of ``tracking_tpu/bgs/gmm.py``:
MixtureOfGaussianV1BGS (ustc type 4, the tracking app's ``--fg FG_1``),
MixtureOfGaussianV2BGS (5, OpenCV's MOG2 with shadow detection),
DPGrimsonGMMBGS (10) and DPZivkovicAGMMBGS (11).

The JAX package keeps the mode banks MODE-MAJOR, ``[K, H, W]`` /
``[K, C, H, W]``, and writes every per-pixel update as whole-map ops in
static loops over K and C; the sorts (by significance w / sigma, or by
weight) are odd-even transposition networks that swap only on a strict
``<`` (a stable sort). This module is that code line by line in torch.
Float order: each sum is written out in index order, constants over a
tensor divide a tensor (Python ``c / t`` is ``t.reciprocal() * c`` in
torch), no ``addcmul`` or ``lerp``, and square roots are correctly rounded
(``ops/xla_math.sqrt``). MOG2's learning rate is a 0-d tensor on the
state's device (it depends on ``t``), so ``1 - alphaT`` and the prune
bound are f32 operations at run time, as in the reference. The JAX
package has no Pallas code for these models, so they are plain torch on
every device.
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops import xla_math
from tracking_tpu_torch.ops.threshold import threshold_binary

_EPS = 1e-12


def _to_planes(frame: torch.Tensor):
    """[H, W(, C)] u8 -> list of C f32 [H, W] planes."""
    f = frame if frame.ndim == 3 else frame[..., None]
    return [f[..., ci].to(torch.float32) for ci in range(f.shape[-1])]


def _sort_desc_maps(key, payloads):
    """Stable descending sort of K parallel [H, W] map-lists by ``key``:
    K rounds of compare-exchange on adjacent pairs, swapping only where
    ``key[i] < key[i + 1]``."""
    K = len(key)
    key = list(key)
    payloads = [list(p) for p in payloads]
    for rnd in range(K):
        for i in range(rnd % 2, K - 1, 2):
            swap = key[i] < key[i + 1]
            key[i], key[i + 1] = torch.where(swap, key[i + 1], key[i]), torch.where(swap, key[i], key[i + 1])
            for p in payloads:
                p[i], p[i + 1] = torch.where(swap, p[i + 1], p[i]), torch.where(swap, p[i], p[i + 1])
    return key, payloads


def _first_match(match):
    """(any match, one-hot first match, prefix-no-match masks)."""
    is_match, considered = [], []
    none_before = torch.ones_like(match[0])
    for m in match:
        considered.append(none_before)
        is_match.append(m & none_before)
        none_before = none_before & ~m
    return ~none_before, is_match, considered


def _index_sum(terms):
    """Σ terms in index order (Python's ``sum`` of the reference)."""
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


def _stack_state(w, var, mu):
    return torch.stack(w), torch.stack(var), torch.stack([torch.stack(mk) for mk in mu])


class _GMMBase(BGSAlgorithm):
    """Shared state layout: w / var [K, H, W] f32, mu [K, C, H, W] f32,
    n [H, W] i32 (mode counts), t [] i32."""

    K_FIELD = "gaussians"

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        K = getattr(self.config, self.K_FIELD)
        c = max(c, 1)
        kw = dict(device=device)
        return {
            "t": torch.zeros((), dtype=torch.int32, **kw),
            "w": torch.zeros((K, h, w), dtype=torch.float32, **kw),
            "var": torch.zeros((K, h, w), dtype=torch.float32, **kw),
            "mu": torch.zeros((K, c, h, w), dtype=torch.float32, **kw),
            "n": torch.zeros((h, w), dtype=torch.int32, **kw),
        }

    def _load(self, state, planes):
        K = getattr(self.config, self.K_FIELD)
        C = len(planes)
        w = list(state["w"].unbind(0))
        var = list(state["var"].unbind(0))
        mu = [list(state["mu"][k].unbind(0)) for k in range(K)]
        dist = []
        for k in range(K):
            d = [mu[k][ci] - planes[ci] for ci in range(C)]
            dist.append(_index_sum([x * x for x in d]))
        active = [state["n"] > k for k in range(K)]
        return K, C, w, var, mu, state["n"], dist, active


def _full(v, dev) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=dev)


def _sort_modes(key, w, var, mu):
    """Sort the modes by ``key`` (descending, stable): (w, var, mu) lists."""
    K, C = len(w), len(mu[0])
    _, (w, var, *mus) = _sort_desc_maps(key, [w, var] + [[mu[k][ci] for k in range(K)] for ci in range(C)])
    return w, var, [[mus[ci][k] for ci in range(C)] for k in range(K)]


def _normalize(w, active, eps, gate=None):
    """Active weights divided by their sum (``gate`` narrows which are)."""
    zero = torch.zeros((), dtype=torch.float32, device=eps.device)
    total = torch.maximum(_index_sum([torch.where(a, wk, zero) for wk, a in zip(w, active)]), eps)
    return [torch.where(a if gate is None else a & gate, wk / total, wk) for wk, a in zip(w, active)]


def _significance(w, var, active, eps):
    """Grimson's sort key w / sigma, -inf on inactive modes."""
    ninf = _full(float("-inf"), eps.device)
    return [torch.where(a, wk / xla_math.sqrt(torch.maximum(vk, eps)), ninf) for wk, vk, a in zip(w, var, active)]


def _by_weight(w, active):
    """Zivkovic's / MOG2's sort key: the weight, -1 on inactive modes."""
    return [torch.where(a, wk, -1.0) for wk, a in zip(w, active)]


def _bg_high(dist, var, w, active, has_match, considered, high_thr, bg_thr):
    """Background where a mode of the background prefix (exclusive weight
    sum below bg_thr) lies within high_thr variances, checked up to and
    including the first match: the dp wrappers' high mask, and MOG2's
    background test on the updated weights."""
    excl = torch.zeros_like(w[0])
    bg = torch.zeros_like(has_match)
    for k in range(len(w)):
        is_bg = (excl < bg_thr) & active[k]
        cons = (considered[k] | ~has_match) & active[k]
        bg = bg | ((dist[k] < var[k] * high_thr) & is_bg & cons)
        excl = excl + w[k]
    return bg


def _new_mode(n, has_match, K, w, var, mu, planes, w_new, var_new):
    """A mode seeded from the frame where nothing matched: slot n (the
    weakest when all K are in use); returns (n', w, var)."""
    n2 = torch.where(has_match, n, torch.clamp(n + 1, max=K))
    w2, var2 = [], []
    for k in range(K):
        slot = (n2 == k + 1) & ~has_match
        w2.append(torch.where(slot, torch.where(n2 == 1, 1.0, w_new), w[k]))
        var2.append(torch.where(slot, var_new, var[k]))
        for ci in range(len(planes)):
            mu[k][ci] = torch.where(slot, planes[ci], mu[k][ci])
    return n2, w2, var2


def _matched_update(k, is_match, kk, mu, var, dist, planes, lo, hi):
    """The matched mode's mean and variance step with rate ``kk``."""
    for ci in range(len(planes)):
        mu[k][ci] = torch.where(is_match[k], mu[k][ci] - kk * (mu[k][ci] - planes[ci]), mu[k][ci])
    return torch.where(is_match[k], torch.clamp(var[k] + kk * (dist[k] - var[k]), lo, hi), var[k])


def _outputs(state, w, var, mu, n, fg, frame, clip):
    """(new state, fg, bg): bg is mode 0's mean as u8, clipped first with
    ``clip``."""
    bg = torch.stack([mu[0][ci] for ci in range(len(mu[0]))], dim=-1)
    bg_u8 = (torch.clamp(bg, 0, 255) if clip else bg).to(torch.uint8)
    if frame.ndim == 2:
        bg_u8 = bg_u8[..., 0]
    ws, vs, ms = _stack_state(w, var, mu)
    return {"t": state["t"] + 1, "w": ws, "var": vs, "mu": ms, "n": n.to(torch.int32)}, fg, bg_u8


@dataclasses.dataclass(frozen=True)
class GrimsonGMMConfig(BGSConfig):
    threshold: float = 9.0  # low threshold (squared stds); high = 2×
    alpha: float = 0.01
    gaussians: int = 3
    showOutput: bool = True


@register("DPGrimsonGMMBGS", type_id=10, aliases=("grimson-gmm",))
class DPGrimsonGMM(_GMMBase):
    """Stauffer-Grimson GMM (``dp/GrimsonGMM.cpp:115-330``) ordered by
    significance w / sigma; emits the high-threshold mask (2 × threshold)
    like every dp wrapper (``gmm.py:152-261``)."""

    Config = GrimsonGMMConfig
    BG_THRESHOLD = 0.75  # GrimsonGMM.cpp:76
    INIT_VAR = 36.0  # GrimsonGMM.cpp:79

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels`` is accepted for the common step
        signature; this algorithm has no kernel)."""
        cfg = self.config
        alpha, init_var = cfg.alpha, self.INIT_VAR
        planes = _to_planes(frame)
        K, C, w, var, mu, n, dist, active = self._load(state, planes)
        eps, a_t = _full(_EPS, planes[0].device), _full(alpha, planes[0].device)

        match = [(dist[k] < var[k] * cfg.threshold) & active[k] for k in range(K)]
        has_match, is_match, considered = _first_match(match)
        bg_high = _bg_high(dist, var, w, active, has_match, considered, 2.0 * cfg.threshold, self.BG_THRESHOLD)

        w1, var1 = [], []
        for k in range(K):
            kk = a_t / torch.maximum(w[k], eps)
            wk = torch.where(active[k], w[k] * (1.0 - alpha), w[k])
            w1.append(torch.where(is_match[k], wk + alpha, wk))
            var1.append(_matched_update(k, is_match, kk, mu, var, dist, planes, 4.0, 5.0 * init_var))
        w1 = _normalize(w1, active, eps)
        w1, var1, mu = _sort_modes(_significance(w1, var1, active, eps), w1, var1, mu)

        n1, w2, var2 = _new_mode(n, has_match, K, w1, var1, mu, planes, a_t, init_var)
        active2 = [n1 > k for k in range(K)]
        w2 = _normalize(w2, active2, eps)
        w2, var2, mu = _sort_modes(_significance(w2, var2, active2, eps), w2, var2, mu)
        fg = torch.where(bg_high, 0, 255).to(torch.uint8)
        return _outputs(state, w2, var2, mu, n1, fg, frame, clip=False)


@dataclasses.dataclass(frozen=True)
class ZivkovicAGMMConfig(BGSConfig):
    threshold: float = 25.0  # DPZivkovicAGMMBGS.cpp defaults
    alpha: float = 0.001
    gaussians: int = 3
    showOutput: bool = True


@register("DPZivkovicAGMMBGS", type_id=11, aliases=("zivkovic-agmm",))
class DPZivkovicAGMM(_GMMBase):
    """Zivkovic's adaptive GMM (``dp/ZivkovicAGMM.cpp:99-407``): modes
    ordered by weight, the complexity prior prunes unmatched modes whose
    weight falls below alpha · 0.05; emits the high mask (``gmm.py:267-377``)."""

    Config = ZivkovicAGMMConfig
    BG_THRESHOLD = 0.75  # ZivkovicAGMM.cpp:64
    INIT_VAR = 36.0
    CT = 0.05  # complexity prior, ZivkovicAGMM.cpp:66

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        cfg = self.config
        alpha, init_var = cfg.alpha, self.INIT_VAR
        prune = -alpha * self.CT
        planes = _to_planes(frame)
        K, C, w, var, mu, n, dist, active = self._load(state, planes)
        eps, a_t = _full(_EPS, planes[0].device), _full(alpha, planes[0].device)

        match = [(dist[k] < var[k] * cfg.threshold) & active[k] for k in range(K)]
        has_match, is_match, considered = _first_match(match)
        bg_high = _bg_high(dist, var, w, active, has_match, considered, 2.0 * cfg.threshold, self.BG_THRESHOLD)

        w1, var1, pruned_n = [], [], torch.zeros_like(n)
        for k in range(K):
            kk = a_t / torch.maximum(w[k], eps)
            wk = torch.where(active[k], w[k] * (1.0 - alpha) + prune, w[k])
            wk = torch.where(is_match[k], wk + alpha, wk)
            var1.append(_matched_update(k, is_match, kk, mu, var, dist, planes, 4.0, 5.0 * init_var))
            # only unmatched modes are pruned (ZivkovicAGMM.cpp:229-255)
            pk = active[k] & ~is_match[k] & (wk < -prune)
            w1.append(torch.where(pk, 0.0, wk))
            pruned_n = pruned_n + pk.to(torch.int32)
        n1 = n - pruned_n
        w1 = _normalize(w1, active, eps)
        w1, var1, mu = _sort_modes(_by_weight(w1, [n1 > k for k in range(K)]), w1, var1, mu)

        n2, w2, var2 = _new_mode(n1, has_match, K, w1, var1, mu, planes, a_t, init_var)
        active2 = [n2 > k for k in range(K)]
        w2 = _normalize(w2, active2, eps, gate=~has_match)
        w2, var2, mu = _sort_modes(_by_weight(w2, active2), w2, var2, mu)
        fg = torch.where(bg_high, 0, 255).to(torch.uint8)
        return _outputs(state, w2, var2, mu, n2, fg, frame, clip=False)


@dataclasses.dataclass(frozen=True)
class MOG2Config(BGSConfig):
    alpha: float = 0.05  # learning rate passed per-frame by the wrapper
    enableThreshold: bool = True
    threshold: int = 15
    showOutput: bool = True
    # OpenCV MOG2 defaults (not exposed by the reference wrapper):
    history: int = 500
    nmixtures: int = 5
    varThreshold: float = 16.0  # Tb
    backgroundRatio: float = 0.9  # TB
    varThresholdGen: float = 9.0  # Tg
    varInit: float = 15.0
    varMin: float = 4.0
    varMax: float = 75.0
    fCT: float = 0.05
    detectShadows: bool = True
    shadowValue: int = 127
    shadowThreshold: float = 0.5  # tau


@register("MixtureOfGaussianV2BGS", type_id=5, aliases=("mog2",))
class MixtureOfGaussianV2(_GMMBase):
    """``cv::BackgroundSubtractorMOG2`` semantics (Zivkovic's algorithm with
    OpenCV's constants and order, ``MixtureOfGaussianV2BGS.cpp:40-62``)
    and the wrapper's binary threshold (``gmm.py:380-532``): the first
    frame learns at 1 / min(2, history) = 0.5; shadows are 127, which the
    threshold at 15 turns into foreground."""

    Config = MOG2Config
    K_FIELD = "nmixtures"

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        cfg = self.config
        Tb, TB = cfg.varThreshold, cfg.backgroundRatio
        planes = _to_planes(frame)
        dev = planes[0].device
        eps = _full(_EPS, dev)
        # OpenCV's schedule: 1 / min(2 nframes, history) on the first frame
        alphaT = torch.where(state["t"] == 0, _full(1.0 / min(2, cfg.history), dev), _full(cfg.alpha, dev))
        alpha1 = 1.0 - alphaT
        prune = -alphaT * cfg.fCT
        K, C, w, var, mu, n, dist, active = self._load(state, planes)

        match = [(dist[k] < var[k] * cfg.varThresholdGen) & active[k] for k in range(K)]
        has_match, is_match, considered = _first_match(match)
        w1 = []
        for k in range(K):
            wk = torch.where(active[k], alpha1 * w[k] + prune, w[k])
            w1.append(torch.where(is_match[k], wk + alphaT, wk))
        # background: running (exclusive) updated weight below TB
        background = _bg_high(dist, var, w1, active, has_match, considered, Tb, TB)

        var1, pruned_n = [], torch.zeros_like(n)
        for k in range(K):
            kk = alphaT / torch.maximum(w1[k], eps)
            var1.append(_matched_update(k, is_match, kk, mu, var, dist, planes, cfg.varMin, cfg.varMax))
            pk = active[k] & ~is_match[k] & (w1[k] < -prune)
            w1[k] = torch.where(pk, 0.0, w1[k])
            pruned_n = pruned_n + pk.to(torch.int32)
        n1 = n - pruned_n
        w1 = _normalize(w1, active, eps)
        w1, var1, mu = _sort_modes(_by_weight(w1, [n1 > k for k in range(K)]), w1, var1, mu)

        # a new mode replaces the weakest when all are in use; the others
        # (where there are others) are scaled by 1 - alphaT
        scale_others = ~has_match & (n1 > 0)
        w1 = [torch.where(scale_others, wk * alpha1, wk) for wk in w1]
        n2, w2, var2 = _new_mode(n1, has_match, K, w1, var1, mu, planes, alphaT, cfg.varInit)
        active2 = [n2 > k for k in range(K)]
        w2, var2, mu = _sort_modes(_by_weight(w2, active2), w2, var2, mu)

        is_shadow = torch.zeros_like(has_match)
        if cfg.detectShadows:  # OpenCV's detectShadowGMM, on non-background pixels
            excl = torch.zeros_like(w2[0])
            for k in range(K):
                numer = _index_sum([planes[ci] * mu[k][ci] for ci in range(C)])
                denom = _index_sum([mu[k][ci] * mu[k][ci] for ci in range(C)])
                a = numer / torch.maximum(denom, eps)
                d = [a * mu[k][ci] - planes[ci] for ci in range(C)]
                dist2a = _index_sum([x * x for x in d])
                is_shadow = is_shadow | (
                    (excl <= TB) & active2[k] & (denom > 0) & (numer <= denom)
                    & (numer >= denom * cfg.shadowThreshold) & (dist2a < var2[k] * Tb * a * a)
                )
                excl = excl + w2[k]
            is_shadow = is_shadow & ~background

        raw = torch.where(background, 0, torch.where(is_shadow, cfg.shadowValue, 255)).to(torch.uint8)
        fg = threshold_binary(raw, cfg.threshold) if cfg.enableThreshold else raw
        return _outputs(state, w2, var2, mu, n2, fg, frame, clip=True)


@dataclasses.dataclass(frozen=True)
class MOG1Config(BGSConfig):
    alpha: float = 0.05
    enableThreshold: bool = True
    threshold: int = 15
    showOutput: bool = True
    # legacy MOG defaults:
    nmixtures: int = 5
    backgroundRatio: float = 0.7
    noiseSigma: float = 30.0
    varThreshold: float = 6.25  # 2.5²


@register("MixtureOfGaussianV1BGS", type_id=4, aliases=("mog1", "mog"))
class MixtureOfGaussianV1(_GMMBase):
    """KaewTraKulPong-Bowden adaptive mixture (legacy
    ``cv::BackgroundSubtractorMOG``, ``MixtureOfGaussianV1BGS.cpp:47-56``):
    modes ordered by w / sigma, a match within 2.5 sigma, the matched mode
    updated with rho = alpha / w, background = a match within the
    backgroundRatio prefix (``gmm.py:536-646``)."""

    Config = MOG1Config
    K_FIELD = "nmixtures"

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels`` is accepted for the common step
        signature; this algorithm has no kernel)."""
        cfg = self.config
        alpha, T = cfg.alpha, cfg.backgroundRatio
        init_var = cfg.noiseSigma * cfg.noiseSigma
        planes = _to_planes(frame)
        K, C, w, var, mu, n, dist, active = self._load(state, planes)
        eps, a_t = _full(_EPS, planes[0].device), _full(alpha, planes[0].device)
        match = [(dist[k] < var[k] * cfg.varThreshold) & active[k] for k in range(K)]
        has_match, is_match, _ = _first_match(match)

        # background prefix by cumulative weight below T (the mode that
        # crosses T included)
        excl = torch.zeros_like(w[0])
        background = torch.zeros_like(has_match)
        for k in range(K):
            background = background | (is_match[k] & (excl < T) & active[k])
            excl = excl + w[k]

        w1, var1 = [], []
        for k in range(K):
            rho = a_t / torch.maximum(w[k], eps)
            wk = torch.where(active[k], w[k] * (1.0 - alpha), w[k])
            w1.append(torch.where(is_match[k], wk + alpha, wk))
            var1.append(_matched_update(k, is_match, rho, mu, var, dist, planes, 4.0, 5.0 * init_var))
        w1 = _normalize(w1, active, eps)
        w1, var1, mu = _sort_modes(_significance(w1, var1, active, eps), w1, var1, mu)

        n2, w2, var2 = _new_mode(n, has_match, K, w1, var1, mu, planes, a_t, init_var)
        active2 = [n2 > k for k in range(K)]
        w2 = _normalize(w2, active2, eps)
        w2, var2, mu = _sort_modes(_significance(w2, var2, active2, eps), w2, var2, mu)

        raw = torch.where(background, 0, 255).to(torch.uint8)
        fg = threshold_binary(raw, cfg.threshold) if cfg.enableThreshold else raw
        return _outputs(state, w2, var2, mu, n2, fg, frame, clip=True)
