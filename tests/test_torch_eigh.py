"""The port's ordered ``ssyevd`` (``tracking_tpu_torch/ops/eigh.py``)
against LAPACK as scipy's OpenBLAS runs it (``scipy.linalg.lapack.ssyevd``,
the library jaxlib calls) on 5,000 seeded symmetric matrices of n = 4, 8,
20 and 25 (1,500, 1,500, 1,200 and 800) and 500 of each n = 26-32 (the
divide and conquer), and against ``jnp.linalg.eigh`` on a few hundred: eigenvalues,
eigenvectors and ``info`` bit for bit. The matrices: Gram matrices of
centred u8 histories (rank-deficient where the history has fewer columns
than rows), the same scaled by 1e-6, 1e6 and 1e-30 (the last below
ssyevd's scaling threshold), zero, and matrices with repeated
eigenvalues."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg.lapack as lapack
import torch

from tracking_tpu_torch.ops import eigh

torch.set_num_threads(1)  # as tests/torch_parity.py: xdist's workers share the cores
SCALES = (1.0, 1e-6, 1e6, 1e-30)


def make(rng, n, kind):
    """One seeded symmetric f32 matrix of the test's six kinds."""
    if kind == 4:
        return np.zeros((n, n), np.float32)
    if kind == 5:  # eigenvalues 0, 1 and 2, each several times
        q = np.linalg.qr(rng.standard_normal((n, n)))[0]
        g = ((q * rng.integers(0, 3, n)) @ q.T).astype(np.float32)
    else:
        x = rng.integers(0, 256, (n, int(rng.integers(2, 4 * n)))).astype(np.float32)
        xc = x - x.mean(1, keepdims=True).astype(np.float32)
        g = (xc @ xc.T).astype(np.float32) * np.float32(SCALES[kind])
    return ((g + g.T) * np.float32(0.5)).astype(np.float32)


def batch(n, count, seed):
    rng = np.random.default_rng(seed)
    return np.stack([make(rng, n, t % 6) for t in range(count)])


@pytest.mark.parametrize("n,count", [(4, 1500), (8, 1500), (20, 1200), (25, 800)])
def test_syevd_matches_lapack(n, count):
    G = batch(n, count, n)
    w, V, info = eigh.syevd(torch.from_numpy(G))
    bad = []
    for b in range(len(G)):
        wr, vr, ir = lapack.ssyevd(G[b], compute_v=1, lower=1)
        if not (np.array_equal(wr, w[b].numpy()) and np.array_equal(vr, V[b].numpy()) and ir == int(info[b])):
            bad.append(b)
    assert not bad, f"{len(bad)} of {len(G)} differ, first {bad[:5]} (kinds {[b % 6 for b in bad[:5]]})"


@pytest.mark.parametrize("n", range(26, 33))
def test_syevd_divide_and_conquer_matches_lapack(n):
    """n = 26-32: sstedc divides and conquers (slaed0-slaed6) on 500 seeded
    matrices of the six kinds: rank-deficient Gram matrices (fewer history
    columns than rows), scaled by 1e-6, 1e6 and 1e-30, zero, and repeated
    eigenvalues, which deflate."""
    G = batch(n, 500, 300 + n)
    w, V, info = eigh.syevd(torch.from_numpy(G))
    bad = []
    for b in range(len(G)):
        wr, vr, ir = lapack.ssyevd(G[b], compute_v=1, lower=1)
        if not (np.array_equal(wr, w[b].numpy()) and np.array_equal(vr, V[b].numpy()) and ir == int(info[b])):
            bad.append(b)
    assert not bad, f"{len(bad)} of {len(G)} differ, first {bad[:5]} (kinds {[b % 6 for b in bad[:5]]})"


JAX_SIZES = [8, 20] + list(range(26, 33))


@functools.lru_cache(maxsize=None)
def jax_eigh():
    """jnp.linalg.eigh of every size's batch in one compiled program."""
    Gs = [batch(n, 150 if n <= 25 else 12, 100 + n) for n in JAX_SIZES]
    out = jax.jit(lambda gs: [jax.vmap(jnp.linalg.eigh)(g) for g in gs])([jnp.asarray(g) for g in Gs])
    return {n: (g, np.asarray(w), np.asarray(v)) for n, g, (w, v) in zip(JAX_SIZES, Gs, out)}


@pytest.mark.parametrize("n", JAX_SIZES)
def test_syevd_matches_jax(n):
    G, wj, vj = jax_eigh()[n]
    w, V, _ = eigh.syevd(torch.from_numpy(G))
    np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(V.numpy(), np.asarray(vj))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_syevd_small_orders(n):
    G = batch(n, 60, 7)
    w, V, info = eigh.syevd(torch.from_numpy(G))
    for b in range(len(G)):
        wr, vr, ir = lapack.ssyevd(G[b], compute_v=1, lower=1)
        np.testing.assert_array_equal(w[b].numpy(), wr)
        np.testing.assert_array_equal(V[b].numpy(), vr)


def test_syevd_refuses_what_it_does_not_reproduce():
    """Above 32 LAPACK's ssytrd (and from 34 sormtr) turns blocked: refused;
    a tensor on another device than the CPU launches the kernel or raises."""
    with pytest.raises(ValueError, match="n <= 32"):
        eigh.syevd_ref(torch.zeros((1, 33, 33)))
    with pytest.raises(ValueError, match="CUDA"):
        eigh.syevd(torch.zeros((1, 4, 4), device="meta"))
