"""Batched constant-velocity Kalman filters for blob tracks, counterpart of
``tracking_tpu/track/kalman.py``: K independent filters over
[x, y, w, h, vx, vy, vw, vh] as one [K, 8] state and [K, 8, 8] covariance."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

DIM_X = 8
DIM_Z = 4


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


def kalman_predict(x, P, params: KalmanParams):
    """x' = Fx; P' = FPFᵀ + Q, batched over the track axis."""
    xp = x @ params.F.T
    Pp = params.F @ P @ params.F.T + params.Q
    return xp, Pp


def kalman_update(x, P, z, gate_mask, params: KalmanParams):
    """Measurement update where ``gate_mask``; other slots pass through."""
    H, R = params.H, params.R
    y = z - x @ H.T
    S = H @ P @ H.T + R
    S_inv = torch.linalg.inv_ex(S).inverse  # no error check: no host sync on the card
    K = P @ H.T @ S_inv
    x_new = x + (K @ y[:, :, None])[:, :, 0]
    eye = torch.eye(DIM_X, dtype=torch.float32, device=x.device)
    P_new = (eye - K @ H) @ P
    x = torch.where(gate_mask[:, None], x_new, x)
    P = torch.where(gate_mask[:, None, None], P_new, P)
    return x, P
