"""The port's ordered ``ssyevd`` (``tracking_tpu_torch/ops/eigh.py``)
against LAPACK as scipy's OpenBLAS runs it (``scipy.linalg.lapack.ssyevd``,
the library jaxlib calls) on 5,000 seeded symmetric matrices of n = 4, 8,
20 and 25 (1,500, 1,500, 1,200 and 800), 500 of each n = 26-32 (the
divide and conquer) and 120 of each n = 33, 34, 40, 50, 51 and 64 (the
blocked ssytrd, slaed0's two levels of cuts from 51, sormqr's blocks at
64), and against ``jnp.linalg.eigh`` on a few hundred: eigenvalues,
eigenvectors and ``info`` bit for bit. The matrices: Gram matrices of
centred u8 histories (rank-deficient where the history has fewer columns
than rows), the same scaled by 1e-6, 1e6 and 1e-30 (the last below
ssyevd's scaling threshold), zero, and matrices with repeated
eigenvalues. The blocked routines alone: ``ssytrd`` against scipy's (with
ssyevd's workspace) and ``sormtr`` against OpenBLAS's ``sormqr`` called as
ssyevd calls it (through ctypes: scipy's wrapper passes a leading
dimension equal to the rows, which OpenBLAS's sgemv answers with another
kernel)."""

import ctypes
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy
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


@pytest.mark.parametrize("n", [33, 34, 40, 50, 51, 64])
def test_syevd_blocked_matches_lapack(n):
    """n = 33-64: ssytrd's slatrd panel and ssyr2k, slaed0's two levels of
    cuts from 51, sormqr's blocks of 3 at 64, on 120 seeded matrices of the
    six kinds."""
    G = batch(n, 120, 500 + n)
    w, V, info = eigh.syevd(torch.from_numpy(G))
    bad = []
    for b in range(len(G)):
        wr, vr, ir = lapack.ssyevd(G[b], compute_v=1, lower=1)
        if not (np.array_equal(wr, w[b].numpy()) and np.array_equal(vr, V[b].numpy()) and ir == int(info[b])):
            bad.append(b)
    assert not bad, f"{len(bad)} of {len(G)} differ, first {bad[:5]} (kinds {[b % 6 for b in bad[:5]]})"


def _sormqr(a: np.ndarray, tau: np.ndarray, z: np.ndarray) -> np.ndarray:
    """OpenBLAS's sormqr('L', 'N') as ssyevd's sormtr calls it: the n - 1
    reflectors below A's subdiagonal (lda n) on Z's rows 1.. (ldc n), with
    ssyevd's workspace of n^2 + 4n + 1."""
    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(scipy.__file__) + ".libs", "libscipy_openblas*.so"))[0])
    n = z.shape[0]
    af, cf = np.array(a, np.float32, order="F"), np.array(z, np.float32, order="F")
    lwork = n * n + 4 * n + 1
    work, info = np.zeros(lwork, np.float32), ctypes.c_int(0)
    ptr, num = (lambda x: x.ctypes.data_as(ctypes.c_void_p)), (lambda v: ctypes.byref(ctypes.c_int(v)))
    lib.scipy_sormqr_(ctypes.c_char_p(b"L"), ctypes.c_char_p(b"N"), num(n - 1), num(n), num(n - 1),
                      ctypes.c_void_p(af.ctypes.data + 4), num(n), ptr(tau), ctypes.c_void_p(cf.ctypes.data + 4),
                      num(n), ptr(work), num(lwork), ctypes.byref(info), ctypes.c_size_t(1), ctypes.c_size_t(1))
    assert info.value == 0
    return cf


@pytest.mark.parametrize("n", [33, 48, 64])
def test_blocked_routines_match_lapack(n):
    """ssytrd (one slatrd panel, ssyr2k, ssytd2: d, e, tau and the
    reflectors) against scipy's with ssyevd's workspace, and sormtr (sorm2r
    up to 63, blocks of 3 reflectors at 64) against OpenBLAS's sormqr, on 4
    seeded matrices each."""
    G = batch(n, 4, 600 + n)
    A, d, e, tau = eigh._ssytrd(torch.from_numpy(G))
    rng = np.random.default_rng(n)
    low = np.tril(np.ones((n, n), bool))
    for b in range(len(G)):
        c, dr, er, tr, ir = lapack.ssytrd(G[b], lower=1, lwork=2 * n * n + 4 * n + 1)
        assert ir == 0
        np.testing.assert_array_equal(d[b].numpy(), dr)
        np.testing.assert_array_equal(e[b].numpy(), er)
        np.testing.assert_array_equal(tau[b].numpy(), tr)
        np.testing.assert_array_equal(A[b].numpy()[low], c[low])
        z = rng.standard_normal((n, n)).astype(np.float32)
        got = eigh._sormtr(A[b : b + 1], tau[b : b + 1], torch.from_numpy(z)[None])[0].numpy()
        np.testing.assert_array_equal(got, _sormqr(c, tr, z))


JAX_SIZES = [8, 20] + list(range(26, 33)) + [33, 34, 51, 64]


@functools.lru_cache(maxsize=None)
def jax_eigh():
    """jnp.linalg.eigh of every size's batch in one compiled program."""
    Gs = [batch(n, 150 if n <= 25 else 12 if n <= 32 else 6, 100 + n) for n in JAX_SIZES]
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
    """Above 64 ssytrd takes a second slatrd panel and slaed0 a third level
    of cuts: refused; a tensor on another device than the CPU launches the
    kernel or raises."""
    with pytest.raises(ValueError, match="n <= 64"):
        eigh.syevd_ref(torch.zeros((1, 65, 65)))
    with pytest.raises(ValueError, match="CUDA"):
        eigh.syevd(torch.zeros((1, 4, 4), device="meta"))
