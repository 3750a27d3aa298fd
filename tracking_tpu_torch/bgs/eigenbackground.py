"""DPEigenbackgroundBGS (ustc type 15, Oliver et al.'s PCA eigenbackground),
counterpart of ``tracking_tpu/bgs/eigenbackground.py`` (``dp/Eigenbackground
.cpp:51-190``, wrapper defaults threshold 225, historySize 20,
embeddedDim 10).

The first historySize frames fill a history matrix (empty masks); at t ==
historySize the PCA basis is built once from it by the Gram trick (the
eigenvectors of the [S, S] matrix Xc Xc^T lifted by Xc and normalised);
every later frame is projected onto the top embeddedDim components and
reconstructed, and a pixel is FG where a channel's squared
reconstruction error exceeds 2 x threshold.

The mean over the history is exact (a sum of u8 values, times f32(1/S),
as XLA:CPU computes ``jnp.mean``). The Gram product ``Xc @ Xc.T`` and the
lift ``evecs.T @ Xc`` run through ``ops/contract.gram`` and ``lift`` (XLA:CPU's dot
orders for every S and D: ``gram_plan``, ``lift_plan``; a 1x1 grey frame's
lift, a matrix-vector product, is the one shape left out), the Gram matrix
is symmetrised as ``jnp.linalg.eigh`` does ((G + G^T) * 0.5), the
eigensolver is LAPACK's ``ssyevd`` in jaxlib's order (``ops/eigh.syevd``:
ssteqr up to 25 frames, sstedc's divide and conquer above, the blocked
ssytrd from 33, two levels of slaed0's cuts from 51, sormqr's blocks at
64; a history above 64 frames takes ``torch.linalg.eigh``, within its
stated tolerance, not bit for bit), the norms are XLA's windowed sums (``ops/pca.row_norms``)
and every frame's projection and reconstruction is ``ops/pca.project``
(XLA's row-major GEMV orders). On the card these are the kernels ``contract``,
``syevd_small`` and ``pca_project``. The JAX package builds the basis
under ``lax.cond``; the port reads ``t`` on the host (one synchronisation
a frame) and builds it only at t == historySize. The history updates in
place (``step`` consumes its state).
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops import eigh
from tracking_tpu_torch.ops.consensus import recip
from tracking_tpu_torch.ops.contract import gram, gram_plan, lift, lift_plan
from tracking_tpu_torch.ops.pca import project, row_norms


@dataclasses.dataclass(frozen=True)
class EigenbackgroundConfig(BGSConfig):
    threshold: int = 225
    historySize: int = 20
    embeddedDim: int = 10
    showOutput: bool = True


def build_pca(history: torch.Tensor, embedded_dim: int, use_kernels: bool = True):
    """(mean [D], basis [E, D]) of a [S, D] u8 history: the top E
    principal directions by the Gram trick, descending by eigenvalue."""
    X = history.to(torch.float32)
    S, D = X.shape
    mean = X.sum(dim=0) * recip(S)
    Xc = X - mean[None]
    G = gram(Xc, gram_plan(S, D), use_kernels=use_kernels)
    G = (G + G.T) * 0.5  # jnp.linalg.eigh symmetrises its input
    if S <= eigh.MAX_N:
        evals, evecs, info = eigh.syevd(G[None], use_kernels)  # ascending
        failed = info[0] != 0  # jnp.linalg.eigh turns LAPACK's failure into NaN
        evals = torch.where(failed, float("nan"), evals[0])
        evecs = torch.where(failed, float("nan"), evecs[0])
    else:  # above 64 frames a second slatrd panel and a third level of cuts: not reproduced (ROADMAP)
        evals, evecs = torch.linalg.eigh(G)
    L = evecs[:, torch.argsort(-evals, stable=True)].T.contiguous()
    comps = lift(L, Xc, lift_plan(S, D), use_kernels=use_kernels)
    comps = comps / torch.clamp(row_norms(comps)[:, None], min=1e-12)
    return mean, comps[:embedded_dim].contiguous()


@register("DPEigenbackgroundBGS", type_id=15, aliases=("eigenbackground",))
class DPEigenbackground(BGSAlgorithm):
    Config = EigenbackgroundConfig

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        S, D = self.config.historySize, h * w * max(c, 1)
        return {
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "history": torch.zeros((S, D), dtype=torch.uint8, device=device),
            "mean": torch.zeros((D,), dtype=torch.float32, device=device),
            "basis": torch.zeros((self.config.embeddedDim, D), dtype=torch.float32, device=device),
        }

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        """One frame; ``use_kernels=False`` runs the plain versions on the card."""
        cfg = self.config
        S = cfg.historySize
        t = int(state["t"])  # the branch's scalar, one synchronisation
        history, mean, basis = state["history"], state["mean"], state["basis"]
        if t == S:
            mean, basis = build_pca(history, cfg.embeddedDim, use_kernels)
        flat = frame.reshape(-1).to(torch.float32)
        recon = project(basis, flat - mean, mean, use_kernels)
        err2 = (flat - recon).square().reshape(frame.shape)
        if frame.ndim == 2:
            err2 = err2[..., None]
        fg_any = (err2 > 2.0 * cfg.threshold).any(dim=-1)
        fg = torch.where(fg_any & (t >= S), 255, 0).to(torch.uint8)
        if t < S:
            history[t] = frame.reshape(-1)
        bg = torch.clamp(recon + 0.5, 0, 255).to(torch.uint8).reshape(frame.shape)
        return {"t": state["t"] + 1, "history": history, "mean": mean, "basis": basis}, fg, bg
