"""The port's Kalman bank (``tracking_tpu_torch/track/kalman.py``) against
the JAX package's (``tracking_tpu/track/kalman.py``), bit for bit.

- ``_inverse`` (OpenBLAS's ``getf2`` and its two ``trsm`` solves written
  out) against LAPACK itself, scipy's ``sgetrf`` + ``strsm`` on the
  permuted identity, which is what ``jnp.linalg.inv`` calls on the CPU:
  12,000 seeded 4 x 4 matrices of seven kinds (random with scaled rows,
  pivoting at every step, ill-conditioned, small integers full of IAMAX
  ties, singular, tiny pivots, magnitudes 1e-3 to 1e4); infinities and
  NaNs where LAPACK has them. (Subnormal entries are left out: OpenBLAS
  picks other pivots among them than the plain IAMAX written here.)
- ``kalman_update`` and ``kalman_predict`` (the plain versions, on CPU
  tensors) against the jitted JAX functions on seeded banks of 32 and 7
  tracks: pivoting covariances, gated-out slots holding −0.0, NaN and
  huge values (kept bit for bit), a singular S (inf / NaN as
  ``jnp.linalg.inv`` gives them), magnitudes 1e-3 to 1e4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import blas, lapack

from tracking_tpu.track import kalman as jk
from tracking_tpu_torch.track import kalman as tk

F32 = np.float32


def _bits_equal(got, want, what):
    """Equal bit patterns, signed zeros included; any NaN matches any NaN."""
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=f"{what}: NaN positions")
    np.testing.assert_array_equal(got.view(np.int32)[~nan], want.view(np.int32)[~nan], err_msg=what)


def _matrices(rng, n):
    """[n, 4, 4] f32, n / 7 of each kind."""
    m = n // 7
    kinds = []
    kinds.append(rng.normal(size=(m, 4, 4)) * np.exp(rng.normal(size=(m, 4, 1)) * 2))  # scaled rows
    d = rng.normal(size=(m, 4, 4)) + np.eye(4) * 10 * rng.choice([-1, 1], size=(m, 1, 4))
    kinds.append(d[:, ::-1, :] * 10.0 ** np.arange(4)[None, :, None])  # a swap at every step
    u = np.linalg.qr(rng.normal(size=(m, 4, 4)))[0]
    v = np.linalg.qr(rng.normal(size=(m, 4, 4)))[0]
    kinds.append(u * 10.0 ** -rng.uniform(0, 7, size=(m, 1, 4)) @ v)  # ill-conditioned
    kinds.append(rng.integers(-2, 3, size=(m, 4, 4)))  # ties for the pivot, some singular
    s = rng.integers(-3, 4, size=(m, 4, 4)).astype(float)
    s[:, :, 3] = s[:, :, 0] - s[:, :, 1]  # singular: a column the difference of two others
    kinds.append(s)
    kinds.append(rng.normal(size=(m, 4, 4)) * 10.0 ** rng.uniform(-15, -10, size=(m, 4, 1)))  # tiny pivots
    kinds.append(rng.normal(size=(n - 6 * m, 4, 4)) * 10.0 ** rng.uniform(-3, 4, size=(n - 6 * m, 4, 4)))
    return np.concatenate(kinds).astype(F32)


def _lapack_inverse(A):
    out = np.empty_like(A)
    eye = np.eye(4, dtype=F32)
    with np.errstate(all="ignore"):
        for i, a in enumerate(A):
            lu, piv, _ = lapack.sgetrf(np.asfortranarray(a))
            perm = np.arange(4)
            for k, p in enumerate(piv):
                perm[[k, p]] = perm[[p, k]]
            y = blas.strsm(1.0, lu, np.asfortranarray(eye[perm]), side=0, lower=1, trans_a=0, diag=1)
            out[i] = blas.strsm(1.0, lu, y, side=0, lower=0, trans_a=0, diag=0)
    return out


def test_inverse_matches_lapack():
    A = _matrices(np.random.default_rng(22), 12_000)
    want = _lapack_inverse(A)
    got = tk._inverse(torch.from_numpy(A)).numpy()
    print(f"{len(A)} matrices, {int(np.isnan(want).any((1, 2)).sum())} with NaN, "
          f"{int(np.isinf(want).any((1, 2)).sum())} with inf in LAPACK's inverse")
    _bits_equal(got, want, "inverse")


def _bank(rng, K, case):
    """(x, P, z, gate) of one case, numpy f32."""
    scale = 10.0 ** rng.uniform(-3, 4, size=(K, 1)) if case == "scales" else 100.0
    x = (rng.normal(size=(K, 8)) * scale).astype(F32)
    A = rng.normal(size=(K, 8, 8)) * np.exp(rng.normal(size=(K, 8, 1)))
    P = A @ A.transpose(0, 2, 1)
    if case == "pivoting":  # the block's largest entries below the diagonal, off by orders
        P[:, :4, :4] = P[:, :4, :4][:, ::-1] * 10.0 ** np.arange(4)[None, :, None]
    if case == "scales":
        P = P * 10.0 ** rng.uniform(-3, 4, size=(K, 1, 1))
    P = P.astype(F32)
    z = (x[:, :4] + rng.normal(size=(K, 4)) * scale).astype(F32)
    gate = rng.uniform(size=K) < 0.75
    if case == "gated":  # gated-out slots hold what must come back bit for bit
        out = ~gate
        x[out] = np.where(rng.uniform(size=(out.sum(), 8)) < 0.5, -0.0, np.nan).astype(F32)
        P[out] = np.where(rng.uniform(size=(out.sum(), 8, 8)) < 0.5, -0.0, 3e38).astype(F32)
    if case == "singular":  # S = P's block + R = 0 on the first slots
        P[:4, :4, :4] = -np.eye(4, dtype=F32) * F32(0.1)
        P[4:8, :4, :4] = np.float32(0.5) - np.eye(4, dtype=F32) * F32(0.1)
        gate[:8] = True
    return x, P, z, gate


CASES = ("random", "pivoting", "gated", "singular", "scales")


@pytest.mark.parametrize("K", [32, 7])
@pytest.mark.parametrize("case", CASES)
def test_update_matches_jax(case, K):
    rng = np.random.default_rng(CASES.index(case) * 100 + K)
    x, P, z, gate = _bank(rng, K, case)
    jx, jP = jax.jit(jk.kalman_update)(x, P, z, gate, jk.default_params())
    tx, tP = tk.kalman_update(*map(torch.from_numpy, (x, P, z, gate)), tk.default_params(device="cpu"))
    _bits_equal(tx.numpy(), jx, "x")
    _bits_equal(tP.numpy(), jP, "P")
    if case == "gated":
        _bits_equal(tx.numpy()[~gate], x[~gate], "gated-out x")
        _bits_equal(tP.numpy()[~gate], P[~gate], "gated-out P")
    if case == "singular":
        assert not np.isfinite(np.asarray(jP)[:8]).all()


@pytest.mark.parametrize("K", [32, 7])
@pytest.mark.parametrize("case", ("random", "scales"))
def test_predict_matches_jax(case, K):
    rng = np.random.default_rng(7 + K)
    x, P, _, _ = _bank(rng, K, case)
    P[:, 4:, :4] *= F32(1.5)  # not symmetric: (F P) Fᵀ and F (P Fᵀ) differ
    jx, jP = jax.jit(jk.kalman_predict)(x, P, jk.default_params())
    tx, tP = tk.kalman_predict(torch.from_numpy(x), torch.from_numpy(P), tk.default_params(device="cpu"))
    _bits_equal(tx.numpy(), jx, "x")
    _bits_equal(tP.numpy(), jP, "P")


def test_steps_chain_like_the_tracker():
    """Twelve predict / update steps of one bank, the update's gate
    changing every step, the states fed back: exact after every step."""
    rng = np.random.default_rng(12)
    x, P, _, _ = _bank(rng, 32, "random")
    jp, tp = jk.default_params(), tk.default_params(device="cpu")
    jpred, jupd = jax.jit(jk.kalman_predict), jax.jit(jk.kalman_update)
    jx, jP, tx, tP = x, P, torch.from_numpy(x), torch.from_numpy(P)
    for t in range(12):
        z = (np.asarray(jx)[:, :4] + rng.normal(size=(32, 4)) * 3).astype(F32)
        gate = rng.uniform(size=32) < 0.7
        jx, jP = jupd(*jpred(jx, jP, jp), z, gate, jp)
        tx, tP = tk.kalman_update(*tk.kalman_predict(tx, tP, tp), torch.from_numpy(z), torch.from_numpy(gate), tp)
        _bits_equal(tx.numpy(), jx, f"x, step {t}")
        _bits_equal(tP.numpy(), jP, f"P, step {t}")
