"""Batched constant-velocity Kalman filters for blob tracks, counterpart of
``tracking_tpu/track/kalman.py``: K independent filters over
[x, y, w, h, vx, vy, vw, vh] as one [K, 8] state and [K, 8, 8] covariance.

The predict and the update are bit for bit the JAX package's on XLA:CPU
(with the tests' flags, fusion off), in its orders of operations:

- each einsum is an XLA ``dot`` that XLA:CPU hands to Eigen's contraction,
  which sums a short dot in four lanes: term k in lane k mod 4, each lane
  an FMA chain, then (l0 + l1) + (l2 + l3); a zero result is +0
  (:func:`_dot`). A three-operand einsum contracts left to right (F P, then
  Fᵀ; P Hᵀ, then S⁻¹);
- ``K y`` (a batched matrix-vector product) is XLA's own row-major emitter:
  one FMA chain a row from +0, in index order (:func:`_chain`);
- ``jnp.linalg.inv`` is LAPACK's ``sgetrf`` and two ``strsm`` (unit lower,
  then upper) on the permuted identity, which jaxlib takes from scipy's
  OpenBLAS; for 4 x 4 that is OpenBLAS's unblocked ``getf2`` and the
  trsm kernels' scalar solve, written out in :func:`_inverse`.

H is 0/1 with one 1 a row (:func:`default_params`), so y = z − Hx and
S = H P Hᵀ + R select P's block: any order gives them exactly.

On CUDA tensors one thread a track runs the whole predict or update in
registers (``csrc/kalman.cu``), with ``__fmaf_rn`` where XLA:CPU fuses;
the wrappers take the plain versions only for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tracking_tpu_torch.ops import _native, xla_math

DIM_X = 8
DIM_Z = 4
_F32 = torch.float32
_FLT_MIN = 1.1754943508222875e-38  # getf2 scales by the pivot's reciprocal from here up, else divides


class KalmanParams(NamedTuple):
    F: torch.Tensor  # [8, 8] transition
    H: torch.Tensor  # [4, 8] measurement
    Q: torch.Tensor  # [8, 8] process noise
    R: torch.Tensor  # [4, 4] measurement noise
    P0: torch.Tensor  # [8, 8] initial covariance


def default_params(process_noise: float = 1e-2, measurement_noise: float = 1e-1, device=None) -> KalmanParams:
    kw = dict(dtype=torch.float32, device=device)
    F = torch.eye(DIM_X, **kw)
    for i in range(4):
        F[i, i + 4] = 1.0
    H = torch.zeros((DIM_Z, DIM_X), **kw)
    H[:4, :4] = torch.eye(4, **kw)
    Q = torch.eye(DIM_X, **kw) * process_noise
    R = torch.eye(DIM_Z, **kw) * measurement_noise
    P0 = torch.eye(DIM_X, **kw)
    return KalmanParams(F, H, Q, R, P0)


def kalman_init(capacity: int, params: KalmanParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x [K, 8] zeros, P [K, 8, 8] = P0 per slot)."""
    x = torch.zeros((capacity, DIM_X), dtype=torch.float32, device=params.F.device)
    P = params.P0.expand(capacity, DIM_X, DIM_X).clone()
    return x, P


def kalman_reset_slot(x, P, mask, z0, params: KalmanParams):
    """Re-initialise masked slots from a measurement (track birth)."""
    newx = torch.cat([z0, torch.zeros_like(z0)], dim=-1)
    x = torch.where(mask[:, None], newx, x)
    P = torch.where(mask[:, None, None], params.P0[None], P)
    return x, P


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_k a[..., k] b[..., k] (broadcast) as Eigen's contraction sums a
    dot of 4 to 8 terms: lane j = the FMA chain of the terms j, j + 4, ...;
    (l0 + l1) + (l2 + l3); + 0 (a lane starts from +0, so the sum of
    products that are all −0 is +0)."""
    n = a.shape[-1]
    lanes = []
    for j in range(4):
        acc = a[..., j] * b[..., j]
        for k in range(j + 4, n, 4):
            acc = xla_math.fma(a[..., k], b[..., k], acc)
        lanes.append(acc)
    return ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])) + 0.0


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """[..., m, k] · [..., k, n] in :func:`_dot`'s order."""
    return _dot(A.unsqueeze(-2), B.transpose(-1, -2).unsqueeze(-3))


def _chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_k a[..., k] b[..., k] as one FMA chain from +0 in index order."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1], dtype=_F32, device=a.device)
    for k in range(a.shape[-1]):
        acc = xla_math.fma(a[..., k], b[..., k], acc)
    return acc


def _inverse(S: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.inv`` of [K, 4, 4] f32 as jaxlib computes it on the CPU.

    OpenBLAS ``sgetrf`` runs ``getf2`` at this size, left-looking, column
    by column: the earlier row swaps applied to the column; its rows 1 .. j−1
    less a dot with L's row (an FMA chain from +0 over the row's terms in
    reverse order); its rows j .. 3 less a matrix-vector product with L's
    block (an FMA chain from +0 a row, in order); the pivot the first
    largest |a| (IAMAX), its row swapped up; the column below it times the
    pivot's f32 reciprocal (divided by the pivot where |pivot| < FLT_MIN;
    left as it is where the pivot is 0: no error, as ``jnp.linalg.inv``
    checks none). Then the permuted identity through the unit lower and the
    upper triangle, right-looking: a row of the solution is the row times
    the diagonal's f32 reciprocal (1 for the unit triangle), then each row
    still to solve takes one FMA, c − x·l."""
    K = S.shape[0]
    dev = S.device
    a = S.clone()
    rows = torch.arange(K, device=dev)
    perm = torch.arange(4, device=dev).expand(K, 4).clone()
    zero = torch.zeros(K, dtype=_F32, device=dev)
    for j in range(4):
        for i in range(1, j):
            acc = zero
            for k in reversed(range(i)):
                acc = xla_math.fma(a[:, i, k], a[:, k, j], acc)
            a[:, i, j] = a[:, i, j] - acc
        for r in range(j, 4) if j else ():
            acc = zero
            for k in range(j):
                acc = xla_math.fma(a[:, r, k], a[:, k, j], acc)
            a[:, r, j] = a[:, r, j] - acc
        jp = torch.full((K,), j, dtype=torch.int64, device=dev)
        best = a[:, j, j].abs()
        for r in range(j + 1, 4):
            v = a[:, r, j].abs()
            better = v > best
            jp = torch.where(better, r, jp)
            best = torch.where(better, v, best)
        row_j, row_p = a[:, j].clone(), a[rows, jp].clone()
        a[rows, jp] = row_j
        a[:, j] = row_p
        pj, pp = perm[:, j].clone(), perm[rows, jp].clone()
        perm[rows, jp] = pj
        perm[:, j] = pp
        piv = a[:, j, j]
        scaled = a[:, j + 1 :, j] * (1.0 / piv)[:, None]
        divided = a[:, j + 1 :, j] / piv[:, None]
        a[:, j + 1 :, j] = torch.where((piv.abs() >= _FLT_MIN)[:, None], scaled,
                                       torch.where((piv != 0)[:, None], divided, a[:, j + 1 :, j]))
    x = (perm[:, :, None] == torch.arange(4, device=dev)).to(_F32)  # row i = e_perm[i]
    for i in range(4):
        for k in range(i + 1, 4):
            x[:, k] = xla_math.fma(-x[:, i], a[:, k, i, None], x[:, k])
    for i in reversed(range(4)):
        x[:, i] = x[:, i] * (1.0 / a[:, i, i])[:, None]
        for k in range(i):
            x[:, k] = xla_math.fma(-x[:, i], a[:, k, i, None], x[:, k])
    return x


def kalman_predict_ref(x, P, params: KalmanParams):
    """Plain torch: x' = F x; P' = (F P) Fᵀ + Q."""
    F = params.F
    return _dot(x[:, None, :], F), _mm(_mm(F, P), F.T) + params.Q


def kalman_update_ref(x, P, z, gate_mask, params: KalmanParams):
    """Plain torch: the measurement update where ``gate_mask``; the other
    slots keep their x and P bit for bit."""
    H, R = params.H, params.R
    y = z - _dot(x[:, None, :], H)
    S = _mm(_mm(H, P), H.T) + R
    K = _mm(_mm(P, H.T), _inverse(S))
    x_new = x + _chain(K, y[:, None, :])
    eye = torch.eye(DIM_X, dtype=_F32, device=x.device)
    P_new = _mm(eye - _mm(K, H), P)
    x = torch.where(gate_mask[:, None], x_new, x)
    P = torch.where(gate_mask[:, None, None], P_new, P)
    return x, P


def kalman_predict(x, P, params: KalmanParams):
    """x' = F x; P' = F P Fᵀ + Q, batched over the track axis. CPU tensors
    take the plain version; CUDA tensors launch ``kalman_predict``."""
    if x.device.type == "cpu":
        return kalman_predict_ref(x, P, params)
    K = x.shape[0]
    x, P = x.contiguous(), P.contiguous()
    _native.require(x, "x", torch.float32, (K, DIM_X))
    _native.require(P, "P", torch.float32, (K, DIM_X, DIM_X))
    F, Q = params.F, params.Q
    _native.require(F, "F", torch.float32, (DIM_X, DIM_X))
    _native.require(Q, "Q", torch.float32, (DIM_X, DIM_X))
    xo, Po = torch.empty_like(x), torch.empty_like(P)
    rc = _native.library().tt_kalman_predict(x.data_ptr(), P.data_ptr(), F.data_ptr(), Q.data_ptr(), xo.data_ptr(),
                                             Po.data_ptr(), K, _native.stream_ptr())
    _native.check(rc, "kalman_predict")
    _native.count_launch("kalman_predict")
    return xo, Po


def kalman_update(x, P, z, gate_mask, params: KalmanParams):
    """Measurement update where ``gate_mask``; other slots pass through.
    CPU tensors take the plain version; CUDA tensors launch
    ``kalman_update``."""
    if x.device.type == "cpu":
        return kalman_update_ref(x, P, z, gate_mask, params)
    K = x.shape[0]
    x, P, z = x.contiguous(), P.contiguous(), z.contiguous()
    _native.require(x, "x", torch.float32, (K, DIM_X))
    _native.require(P, "P", torch.float32, (K, DIM_X, DIM_X))
    _native.require(z, "z", torch.float32, (K, DIM_Z))
    gate = gate_mask.contiguous()
    _native.require(gate, "gate_mask", torch.bool, (K,))
    H, R = params.H, params.R
    _native.require(H, "H", torch.float32, (DIM_Z, DIM_X))
    _native.require(R, "R", torch.float32, (DIM_Z, DIM_Z))
    xo, Po = torch.empty_like(x), torch.empty_like(P)
    rc = _native.library().tt_kalman_update(x.data_ptr(), P.data_ptr(), z.data_ptr(), gate.data_ptr(),
                                            H.data_ptr(), R.data_ptr(), xo.data_ptr(), Po.data_ptr(), K,
                                            _native.stream_ptr())
    _native.check(rc, "kalman_update")
    _native.count_launch("kalman_update")
    return xo, Po
