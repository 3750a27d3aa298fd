"""The lb-package BGS family (Laurence Bender's BGModel framework, SURVEY
§2.5), counterpart of ``tracking_tpu/bgs/lb.py``: LBSimpleGaussian
(ustc type 25), LBFuzzyGaussian (26), LBMixtureOfGaussians (27),
LBAdaptiveSOM (28) and LBFuzzyAdaptiveSOM (29).

The wrappers (``package_bgs/LBSimpleGaussian.cpp:31-72``) seed the model
from the first frame and update it on every frame, that one included; the
XML's integer parameters map through value / 255 curves, computed here in
Python doubles as in the reference and used as f32 constants. The models
are per-pixel recurrences in f32, written in the reference's order: a
division by a constant is XLA's product by the f32 reciprocal
(``ops/consensus.recip``), a division by a tensor stays a division, each
square is one product, channel and mode sums run left to right, and the
fuzzy learning rates take XLA:CPU's ``exp`` (``ops/xla_math.exp``), whose
1-ulp differences from torch's would compound through the state. The JAX
package has no Pallas code for these models, so they are plain torch on
every device.
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.bgs.gmm import _full, _index_sum
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops import xla_math
from tracking_tpu_torch.ops.color import fold
from tracking_tpu_torch.ops.consensus import recip

_F32 = torch.float32


def _to_f32_channels(frame: torch.Tensor):
    """[H, W] or [H, W, C] u8 -> C-tuple of [H, W] f32."""
    if frame.ndim == 2:
        return (frame.to(_F32),)
    return tuple(frame[..., c].to(_F32) for c in range(frame.shape[-1]))


def _bg_u8(mu_channels, gray: bool) -> torch.Tensor:
    """The mean image as u8: clipped, then truncated."""
    planes = tuple(torch.clamp(m, 0, 255).to(torch.uint8) for m in mu_channels)
    return planes[0] if gray else torch.stack(planes, dim=-1)


def _seed_gauss(state, src, init_noise):
    """Frame 0 seeds the means from the frame and the variances with the
    constructor's noise; later frames read the state."""
    t = state["t"]
    mu = tuple(torch.where(t == 0, s, m) for s, m in zip(src, state["mu"]))
    var = tuple(torch.where(t == 0, _full(init_noise, s.device), v) for s, v in zip(src, state["var"]))
    return mu, var


def _mahalanobis(src, mu, var):
    """(per-channel differences, Σ_c d² / var)."""
    d = tuple(s - m for s, m in zip(src, mu))
    return d, _index_sum([x * x / v for x, v in zip(d, var)])


@dataclasses.dataclass(frozen=True)
class LBSimpleGaussianConfig(BGSConfig):
    sensitivity: int = 66
    noiseVariance: int = 162
    learningRate: int = 18
    showOutput: bool = True


class _GaussBase(BGSAlgorithm):
    """A diagonal Gaussian a pixel: mu and var, C-tuples of [H, W] f32."""

    INIT_NOISE = 50.0  # ctor NOISEGAUSS / NOISEFUZZYGAUSS, the frame-0 variance seed

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        c = max(c, 1)
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tuple(torch.zeros((h, w), dtype=_F32, device=device) for _ in range(c)),
            "var": tuple(torch.full((h, w), self.INIT_NOISE, dtype=_F32, device=device) for _ in range(c)),
        }


@register("LBSimpleGaussian", type_id=25, aliases=("lb-gauss",))
class LBSimpleGaussian(_GaussBase):
    """A diagonal Gaussian a pixel with a Mahalanobis test
    (``lb/BGModelGauss.cpp:125-198``)."""

    Config = LBSimpleGaussianConfig

    def _params(self):
        cfg = self.config
        thr = 100.0 * (cfg.sensitivity / 255.0) ** 2
        noise = 100.0 * (cfg.noiseVariance / 255.0)
        alpha = (cfg.learningRate / 255.0) ** 3
        return thr, noise, alpha

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels`` is accepted for the common step
        signature; this algorithm has no kernel)."""
        thr, noise, alpha = self._params()
        src = _to_f32_channels(frame)
        mu, var = _seed_gauss(state, src, self.INIT_NOISE)
        d, d2 = _mahalanobis(src, mu, var)
        fg = torch.where(d2 < thr, 0, 255).to(torch.uint8)
        mu2 = tuple(m + x * alpha for m, x in zip(mu, d))
        var2 = tuple(torch.clamp(v + ((s - m2) * (s - m2) - v) * alpha, max=noise) for s, m2, v in zip(src, mu2, var))
        return {"t": state["t"] + 1, "mu": mu2, "var": var2}, fg, _bg_u8(mu2, frame.ndim == 2)


@dataclasses.dataclass(frozen=True)
class LBFuzzyGaussianConfig(BGSConfig):
    sensitivity: int = 72
    bgThreshold: int = 162
    learningRate: int = 49
    noiseVariance: int = 195
    showOutput: bool = True


@register("LBFuzzyGaussian", type_id=26, aliases=("lb-fuzzy-gauss",))
class LBFuzzyGaussian(_GaussBase):
    """The Gaussian with a learning rate that a fuzzy membership modulates
    (``lb/BGModelFuzzyGauss.cpp:129-210``)."""

    FUZZYEXP = -5.0

    Config = LBFuzzyGaussianConfig

    def _params(self):
        cfg = self.config
        thr = 100.0 * (cfg.sensitivity / 255.0) ** 2
        thr_bg = cfg.bgThreshold / 255.0
        alphamax = (cfg.learningRate / 255.0) ** 3
        noise = 100.0 * (cfg.noiseVariance / 255.0)
        return thr, thr_bg, alphamax, noise

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        thr, thr_bg, alphamax, noise = self._params()
        src = _to_f32_channels(frame)
        mu, var = _seed_gauss(state, src, self.INIT_NOISE)
        d, d2 = _mahalanobis(src, mu, var)
        fuzzy_bg = torch.where(d2 < thr, d2 * recip(thr), 1.0)
        alpha = xla_math.exp(fuzzy_bg * self.FUZZYEXP) * alphamax
        mu2 = tuple(m + alpha * x for m, x in zip(mu, d))
        var2 = tuple(torch.clamp(v + alpha * ((s - m2) * (s - m2) - v), min=noise) for s, m2, v in zip(src, mu2, var))
        fg = torch.where(fuzzy_bg >= thr_bg, 255, 0).to(torch.uint8)
        return {"t": state["t"] + 1, "mu": mu2, "var": var2}, fg, _bg_u8(mu2, frame.ndim == 2)


@dataclasses.dataclass(frozen=True)
class LBMixtureOfGaussiansConfig(BGSConfig):
    sensitivity: int = 81
    bgThreshold: int = 83
    learningRate: int = 59
    noiseVariance: int = 206
    showOutput: bool = True


@register("LBMixtureOfGaussians", type_id=27, aliases=("lb-mog",))
class LBMixtureOfGaussians(BGSAlgorithm):
    """K = 3 mixture with the legacy quirks (``lb/BGModelMog.cpp:144-306``):
    a first-match scan, the single-swap "sort" (the matched mode swaps with
    the first earlier mode it beats on w / sigma), and the FG test of the
    matched mode's pre-swap index against the background-weight prefix."""

    K = 3
    INIT_NOISE = 50.0
    NEW_WEIGHT = 0.001  # LEARNINGRATEMOG, the new mode's weight

    Config = LBMixtureOfGaussiansConfig

    def _params(self):
        cfg = self.config
        thr = 100.0 * (cfg.sensitivity / 255.0) ** 2
        T = cfg.bgThreshold / 255.0
        alpha = (cfg.learningRate / 255.0) ** 3
        noise = 100.0 * (cfg.noiseVariance / 255.0)
        return thr, T, alpha, noise

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        c, K = max(c, 1), self.K
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tuple(torch.zeros((K, h, w), dtype=_F32, device=device) for _ in range(c)),
            "var": tuple(torch.full((K, h, w), self.INIT_NOISE, dtype=_F32, device=device) for _ in range(c)),
            "w": torch.zeros((K, h, w), dtype=_F32, device=device),
            "n": torch.zeros((h, w), dtype=torch.int32, device=device),
        }

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels``: the common step signature; no kernel)."""
        thr, T, alpha, noise = self._params()
        K = self.K
        src = _to_f32_channels(frame)
        c = len(src)
        t = state["t"]
        first = t == 0
        dev = src[0].device
        zero = _full(0.0, dev)

        # frame 0: mode 0 = the frame with weight 1 (Init(), BGModelMog.cpp:111-140)
        mu = [[torch.where(first, src[i] if k == 0 else zero, state["mu"][i][k]) for k in range(K)] for i in range(c)]
        var = [[torch.where(first, _full(self.INIT_NOISE, dev), v) for v in state["var"][i]] for i in range(c)]
        w = [torch.where(first, _full(1.0 if k == 0 else 0.0, dev), state["w"][k]) for k in range(K)]
        n = torch.where(first, 1, state["n"]).to(torch.int32)

        active = [n > k for k in range(K)]
        d2 = []
        for k in range(K):
            dk = [src[i] - mu[i][k] for i in range(c)]
            d2.append(_index_sum([x * x / var[i][k] for i, x in enumerate(dk)]))
        match = [(d2[k] < thr) & active[k] for k in range(K)]
        none_before = torch.ones_like(match[0])
        is_first = []
        for k in range(K):
            is_first.append(match[k] & none_before)
            none_before = none_before & ~match[k]
        has_match = ~none_before

        # a new mode where nothing matched (BGModelMog.cpp:231-251)
        n2 = torch.where(has_match, n, torch.clamp(n + 1, max=K))
        first_idx = _index_sum([torch.where(is_first[k], k, 0) for k in range(K)])
        k_hit = torch.where(has_match, first_idx, n2 - 1)
        is_hit = [k_hit == k for k in range(K)]
        active2 = [n2 > k for k in range(K)]

        new_w = torch.where(n2 == 1, 1.0, self.NEW_WEIGHT).to(_F32)
        w2 = []
        for k in range(K):
            w_m = torch.where(is_hit[k], w[k] + (1.0 - w[k]) * alpha, w[k] * (1.0 - alpha))
            w2.append(torch.where(has_match, w_m, torch.where(is_hit[k], new_w, w[k])))
        mu2, var2 = [], []
        for i in range(c):
            mu_i, var_i = [], []
            for k in range(K):
                d = src[i] - mu[i][k]
                mu_m = torch.where(is_hit[k], mu[i][k] + d * alpha, mu[i][k])
                e = src[i] - mu_m
                var_m = torch.where(is_hit[k], torch.clamp(var[i][k] + (e * e - var[i][k]) * alpha, min=noise),
                                    var[i][k])
                mu_i.append(torch.where(has_match, mu_m, torch.where(is_hit[k], src[i], mu[i][k])))
                var_i.append(torch.where(has_match, var_m, torch.where(is_hit[k], _full(noise, dev), var[i][k])))
            mu2.append(mu_i)
            var2.append(var_i)

        # normalise, sort key (BGModelMog.cpp:253-263)
        eps = _full(1e-12, dev)
        total = torch.maximum(_index_sum([torch.where(active2[k], w2[k], zero) for k in range(K)]), eps)
        w2 = [torch.where(active2[k], w2[k] / total, w2[k]) for k in range(K)]
        sort_key = [w2[k] / xla_math.sqrt(_index_sum([var2[i][k] for i in range(c)])) for k in range(K)]

        # single swap: k_hit with the FIRST j < k_hit whose key it beats
        # (BGModelMog.cpp:267-274)
        key_hit = _index_sum([torch.where(is_hit[k], sort_key[k], zero) for k in range(K)])
        none_beat_before = torch.ones_like(has_match)
        is_jswap = []
        for k in range(K):
            beats_k = (k_hit > k) & (key_hit > sort_key[k])
            is_jswap.append(beats_k & none_beat_before)
            none_beat_before = none_beat_before & ~beats_k
        any_beat = ~none_beat_before

        def swap(arrs):
            val_hit = _index_sum([torch.where(is_hit[k], arrs[k], zero) for k in range(K)])
            val_js = _index_sum([torch.where(is_jswap[k], arrs[k], zero) for k in range(K)])
            out = []
            for k in range(K):
                v = torch.where(any_beat & is_hit[k], val_js, arrs[k])
                out.append(torch.where(any_beat & is_jswap[k], val_hit, v))
            return out

        w3 = swap(w2)
        mu3 = [swap(mu2[i]) for i in range(c)]
        var3 = [swap(var2[i]) for i in range(c)]

        # background prefix: the first k whose running weight passes T (after
        # the swap); FG iff the pre-swap hit index lies past it (:278-294)
        cum = torch.zeros_like(w3[0])
        k_bg = torch.full_like(n2, K - 1)
        found = torch.zeros_like(has_match)
        for k in range(K):
            cum = cum + torch.where(active2[k], w3[k], zero)
            over = (cum > T) & ~found
            k_bg = torch.where(over, k, k_bg)
            found = found | over
        fg = torch.where(k_hit > k_bg, 255, 0).to(torch.uint8)

        bg = _bg_u8(tuple(mu3[i][0] for i in range(c)), frame.ndim == 2)
        new_state = {
            "t": t + 1,
            "mu": tuple(torch.stack(mu3[i]) for i in range(c)),
            "var": tuple(torch.stack(var3[i]) for i in range(c)),
            "w": torch.stack(w3),
            "n": n2.to(torch.int32),
        }
        return new_state, fg, bg


# the 3 × 3 SOM a pixel; the Pascal neighbourhood [1, 2, 1] ⊗ [1, 2, 1]
# (BGModelSom.cpp:77-99), Wmax = 4
_SOM_M = 3


@dataclasses.dataclass(frozen=True)
class LBAdaptiveSOMConfig(BGSConfig):
    sensitivity: int = 75
    trainingSensitivity: int = 245
    learningRate: int = 62
    trainingLearningRate: int = 255
    trainingSteps: int = 55
    showOutput: bool = True


class _SOMBase(BGSAlgorithm):
    """A 3 × 3 self-organising map a pixel (``lb/BGModelSom.cpp:185-290``,
    ``lb/BGModelFuzzySom.cpp:218-320``): the best-matching unit and its
    neighbours move towards the frame; the first trainingSteps frames
    calibrate with a wider threshold and a falling learning rate."""

    fuzzy = False
    FUZZYEXP = -5.0
    FUZZYTHRESH = 0.8

    def _params(self):
        cfg = self.config
        eps2 = 255.0 * 255.0 * (cfg.sensitivity / 255.0) ** 4
        eps1 = 255.0 * 255.0 * (cfg.trainingSensitivity / 255.0) ** 4
        wmax = 4.0
        alpha2 = (cfg.learningRate / 255.0) ** 3 / wmax
        alpha1 = (cfg.trainingLearningRate / 255.0) ** 3 / wmax
        return eps1, eps2, alpha1, alpha2, cfg.trainingSteps

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        c, G = max(c, 1), _SOM_M * _SOM_M
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "som": tuple(torch.zeros((G, h, w), dtype=_F32, device=device) for _ in range(c)),
            "bg": tuple(torch.zeros((h, w), dtype=_F32, device=device) for _ in range(c)),
        }

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame (``use_kernels`` is accepted for the common step
        signature; this algorithm has no kernel)."""
        eps1, eps2, alpha1, alpha2, tsteps = self._params()
        src = _to_f32_channels(frame)
        t = state["t"]
        G = _SOM_M * _SOM_M
        som = tuple(torch.where(t == 0, s[None].expand(G, *s.shape), m) for s, m in zip(src, state["som"]))

        # calibration schedule (BGModelSom.cpp:187-199): m_K counts frames;
        # XLA turns t · (alpha1 − alpha2) / tsteps into one product by the
        # folded constant f32(f32(alpha1 − alpha2) · f32(1 / tsteps))
        in_train = t <= tsteps
        eps = torch.where(in_train, _full(eps1, t.device), _full(eps2, t.device))
        alpha = torch.where(in_train, alpha1 - t.to(_F32) * fold(alpha1 - alpha2, recip(tsteps)),
                            _full(alpha2, t.device))

        diffs = [s[None] - m for s, m in zip(src, som)]
        d2 = _index_sum([x * x for x in diffs])  # [G, H, W]
        d2min, bmu = d2.min(dim=0)  # the first minimum on ties, as jnp.argmin

        if self.fuzzy:
            fuzzy_bg = torch.where(d2min < eps, d2min / eps, 1.0)
            a_eff = alpha * xla_math.exp(fuzzy_bg * self.FUZZYEXP)
            do_update = torch.ones_like(d2min, dtype=torch.bool)
            is_fg = fuzzy_bg >= self.FUZZYTHRESH
        else:
            a_eff = alpha.expand(d2min.shape)
            do_update = d2min <= eps
            is_fg = ~do_update

        # the neighbourhood of the BMU in grid coordinates; updates that fall
        # off the grid land in the reference's write-only padding: dropped
        by, bx = bmu // _SOM_M, bmu % _SOM_M
        a_cell = []
        for g in range(G):
            dy, dx = g // _SOM_M - by, g % _SOM_M - bx
            in_win = (dy.abs() <= 1) & (dx.abs() <= 1) & do_update
            wgt = torch.where(dy == 0, 2.0, 1.0) * torch.where(dx == 0, 2.0, 1.0)
            a_cell.append((in_win, a_eff * wgt))
        new_som = tuple(
            torch.stack([torch.where(iw, m[g] + a * (s - m[g]), m[g]) for g, (iw, a) in enumerate(a_cell)])
            for s, m in zip(src, som)
        )

        # the background image: the BMU's value where it is background
        bmu_val = tuple(m.gather(0, bmu[None])[0] for m in new_som)
        bg_t = tuple(torch.where(is_fg, torch.where(t == 0, s, b), v) for s, b, v in zip(src, state["bg"], bmu_val))
        fg = torch.where(is_fg, 255, 0).to(torch.uint8)
        return {"t": t + 1, "som": new_som, "bg": bg_t}, fg, _bg_u8(bg_t, frame.ndim == 2)


@register("LBAdaptiveSOM", type_id=28, aliases=("lb-som",))
class LBAdaptiveSOM(_SOMBase):
    Config = LBAdaptiveSOMConfig
    fuzzy = False


@dataclasses.dataclass(frozen=True)
class LBFuzzyAdaptiveSOMConfig(BGSConfig):
    sensitivity: int = 90
    trainingSensitivity: int = 240
    learningRate: int = 38
    trainingLearningRate: int = 255
    trainingSteps: int = 81
    showOutput: bool = True


@register("LBFuzzyAdaptiveSOM", type_id=29, aliases=("lb-fuzzy-som",))
class LBFuzzyAdaptiveSOM(_SOMBase):
    Config = LBFuzzyAdaptiveSOMConfig
    fuzzy = True
