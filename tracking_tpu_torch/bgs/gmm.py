"""Per-pixel Gaussian-mixture BGS, counterpart of ``tracking_tpu/bgs/gmm.py``
for MixtureOfGaussianV1BGS (ustc type 4, the tracking app's ``--fg FG_1``).

The JAX package keeps the mode banks MODE-MAJOR, ``[K, H, W]`` /
``[K, C, H, W]``, and writes every per-pixel update as whole-map ops in
static loops over K and C; the sort by significance is an odd-even
transposition network that swaps only on a strict ``<`` (a stable sort).
This module is that code line by line in torch. Float order: each sum is
written out in index order, constants over a tensor divide a tensor
(Python ``c / t`` is ``t.reciprocal() * c`` in torch), no ``addcmul`` or
``lerp``, and square roots are correctly rounded (``ops/xla_math.sqrt``).
No TPU kernel lies on this path, so it is plain torch on every device.
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
        alpha, T, vT = cfg.alpha, cfg.backgroundRatio, cfg.varThreshold
        init_var = cfg.noiseSigma * cfg.noiseSigma
        planes = _to_planes(frame)
        K, C, w, var, mu, n, dist, active = self._load(state, planes)
        dev = planes[0].device

        def full(v):
            return torch.full((), v, dtype=torch.float32, device=dev)

        eps, a_t = full(_EPS), full(alpha)
        match = [(dist[k] < var[k] * vT) & active[k] for k in range(K)]
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
            for ci in range(C):
                mu[k][ci] = torch.where(is_match[k], mu[k][ci] - rho * (mu[k][ci] - planes[ci]), mu[k][ci])
            var1.append(torch.where(is_match[k], torch.clamp(var[k] + rho * (dist[k] - var[k]), 4.0, 5.0 * init_var),
                                    var[k]))
        zero = full(0.0)
        total = _index_sum([torch.where(active[k], w1[k], zero) for k in range(K)])
        w1 = [torch.where(active[k], w1[k] / torch.maximum(total, eps), w1[k]) for k in range(K)]
        ninf = full(float("-inf"))
        sig = [torch.where(active[k], w1[k] / xla_math.sqrt(torch.maximum(var1[k], eps)), ninf) for k in range(K)]
        _, (w1, var1, *mus) = _sort_desc_maps(sig, [w1, var1] + [[mu[k][ci] for k in range(K)] for ci in range(C)])
        mu = [[mus[ci][k] for ci in range(C)] for k in range(K)]

        n2 = torch.where(has_match, n, torch.clamp(n + 1, max=K))
        w2, var2 = [], []
        for k in range(K):
            slot = (n2 == k + 1) & ~has_match
            w2.append(torch.where(slot, torch.where(n2 == 1, full(1.0), a_t), w1[k]))
            var2.append(torch.where(slot, full(init_var), var1[k]))
            for ci in range(C):
                mu[k][ci] = torch.where(slot, planes[ci], mu[k][ci])
        active2 = [n2 > k for k in range(K)]
        total2 = _index_sum([torch.where(active2[k], w2[k], zero) for k in range(K)])
        w2 = [torch.where(active2[k], w2[k] / torch.maximum(total2, eps), w2[k]) for k in range(K)]
        sig2 = [torch.where(active2[k], w2[k] / xla_math.sqrt(torch.maximum(var2[k], eps)), ninf) for k in range(K)]
        _, (w2, var2, *mus) = _sort_desc_maps(sig2, [w2, var2] + [[mu[k][ci] for k in range(K)] for ci in range(C)])
        mu = [[mus[ci][k] for ci in range(C)] for k in range(K)]

        raw = torch.where(background, 0, 255).to(torch.uint8)
        fg = threshold_binary(raw, cfg.threshold) if cfg.enableThreshold else raw
        bg_u8 = torch.clamp(torch.stack([mu[0][ci] for ci in range(C)], dim=-1), 0, 255).to(torch.uint8)
        if frame.ndim == 2:
            bg_u8 = bg_u8[..., 0]
        ws, vs, ms = _stack_state(w2, var2, mu)
        new_state = {"t": state["t"] + 1, "w": ws, "var": vs, "mu": ms, "n": n2.to(torch.int32)}
        return new_state, fg, bg_u8
