"""Read the orders of additions that ``tracking_tpu_torch/ops/contract.py``
and ``ops/eigh.py`` reproduce off the libraries themselves, on this host.

Three-leaf probes: terms 1, 0.75·2⁻²⁴ and −1 at three positions, zeros
elsewhere; the sum is 0.75·2⁻²⁴, 0 or 2⁻²⁴ as the first two, the first and
third or the last two were added first, which places one leaf against two
others (a rooted triplet). A tree is rebuilt by inserting leaves one at a
time, descending from the root by one probe a level. Two-leaf probes then
read each join: with two nonzero terms whose products nearly cancel, the
sum tells an FMA from a rounded product added.

    python tools/probe_orders.py gram S D             # Xc @ Xc.T: tree and joins
    python tools/probe_orders.py gram-blocks S D      # the Gram kernel's block starts
    python tools/probe_orders.py lift S D [COL ...]   # evecs.T @ Xc at columns COL
    python tools/probe_orders.py lift-splits S D      # its chains' starts, column by column
    python tools/probe_orders.py sgemv KIND ROWS [LDA]  # OpenBLAS's sgemv 'T' form (KIND 4, 2, 1)
    python tools/probe_orders.py slaed4 [COUNT]       # ops/eigh's secular solver against scipy's
    python tools/probe_orders.py sstedc N [COUNT]     # ops/eigh's divide and conquer against scipy's
    python tools/probe_orders.py blas                 # OpenBLAS's srot and small sgemm: fused where
    python tools/probe_orders.py workspace N          # ilaenv's NB, NX, SMLSIZ; sormqr's block in ssyevd's lwork
    python tools/probe_orders.py sdot N               # OpenBLAS's sdot: tree and joins
    python tools/probe_orders.py sgemv-n ROWS COLS ROW [LDA]     # sgemv 'N' (alpha -1, beta 1): a row's tree
    python tools/probe_orders.py sgemm TA TB M N K ROW COL [BETA]  # an sgemm output's tree (C a leaf if BETA)
    python tools/probe_orders.py ssytrd N [COUNT]     # ops/eigh's blocked ssytrd against scipy's
    python tools/probe_orders.py sormtr N [COUNT]     # ops/eigh's sormtr against OpenBLAS's sormqr as ssyevd calls it
    python tools/probe_orders.py gram-kinds S0 S1 D,D,..   # the Gram product's lanes (c: one chain, 2, 4)
    python tools/probe_orders.py lift-kinds S0 S1 D,D,..   # the lift's order a depth at 51-64 rows

Run with ``JAX_PLATFORMS=cpu``. The outputs are what the rules in those
modules were written from; compare a new host's with them before trusting
the rules there.
"""

from __future__ import annotations

import ctypes
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EPS = np.float32(0.75 * 2.0 ** -24)


def decode(v) -> str:
    if v == 0:
        return "ab"
    if v == EPS:
        return "ac"
    if v == np.float32(2.0 ** -24):
        return "bc"
    raise ValueError(f"not a three-leaf sum: {v!r}")


def first(t):
    return t if isinstance(t, int) else first(t[0])


def build(probe, leaves):
    """The binary tree over ``leaves`` that ``probe.query`` answers for."""
    tree = leaves[0]
    for x in leaves[1:]:
        path, node = [], tree
        while not isinstance(node, int):
            r = probe.query([(first(node[0]), x, first(node[1]))])[0]
            if r == "ac":
                break
            path.append(0 if r == "ab" else 1)
            node = node[path[-1]]

        def rep(t, p):
            if not p:
                return (t, x)
            return (rep(t[0], p[1:]), t[1]) if p[0] == 0 else (t[0], rep(t[1], p[1:]))

        tree = rep(tree, path)
    return tree


def show(t) -> str:
    return str(t) if isinstance(t, int) else f"({show(t[0])}+{show(t[1])})"


def fma(a, b, c):
    import torch

    from tracking_tpu_torch.ops import xla_math

    t = lambda v: torch.tensor([v], dtype=torch.float32)
    return np.float32(xla_math.fma(t(a), t(b), t(c))[0])


def joins(tree, run, n_terms, trials: int = 24, seed: int = 0):
    """Each join with a leaf: 'F' (the leaf's product fused onto the sum),
    'M' (rounded, then added) or, for a pair of leaves, 'R' (the later
    leaf's product rounded, the earlier fused onto it). ``run(a, v)`` sums
    a * v over the terms."""
    rng = np.random.default_rng(seed)
    out = {}

    def walk(t):
        if isinstance(t, int):
            return
        a, b = t
        if isinstance(a, int) or isinstance(b, int):
            pair = isinstance(a, int) and isinstance(b, int)
            x, y = (min(a, b), max(a, b)) if pair else ((first(b), a) if isinstance(a, int) else (first(a), b))
            ok = {"F", "M", "R"} if pair else {"F", "M"}
            for k in range(trials):
                av = np.zeros(n_terms, np.float32)
                v = rng.standard_normal(n_terms).astype(np.float32)
                av[x], av[y] = rng.standard_normal(2)
                if k % 2:  # nearly opposite products: a product's rounding shows
                    av[x] = np.float32(-av[y] * v[y] / v[x])
                got = run(av, v)
                px, py = np.float32(av[x] * v[x]), np.float32(av[y] * v[y])
                cand = {"M": np.float32(px + py), "F": fma(av[y], v[y], px), "R": fma(av[x], v[x], py)}
                ok &= {j for j, val in cand.items() if val == got}
            out[(x, y)] = "".join(sorted(ok))
        if not isinstance(a, int):
            walk(a)
        if not isinstance(b, int):
            walk(b)

    walk(tree)
    return out


class GramProbe:
    """out[i, 0] of jax.jit(x @ x.T) with row 0 all ones: S - 1 probes a call."""

    def __init__(self, s: int, d: int):
        import jax

        self.s, self.d = s, d
        self.f = jax.jit(lambda x: x @ x.T)

    def query(self, trips):
        out = []
        for q in range(0, len(trips), self.s - 1):
            chunk = trips[q : q + self.s - 1]
            X = np.zeros((self.s, self.d), np.float32)
            X[0] = 1
            for r, (a, b, c) in enumerate(chunk, 1):
                X[r, a], X[r, b], X[r, c] = 1, EPS, -1
            g = np.asarray(self.f(X))
            out += [decode(g[r, 0]) for r in range(1, len(chunk) + 1)]
        return out

    def run(self, a, v):
        X = np.zeros((self.s, self.d), np.float32)
        X[0], X[1] = v, a
        return np.asarray(self.f(X))[1, 0]


class LiftProbe:
    """out[i, col] of jax.jit(l @ x) with x all ones: S probes a call, every column at once."""

    def __init__(self, s: int, d: int, col: int = 0):
        import jax

        self.s, self.d, self.col = s, d, col
        self.f = jax.jit(lambda l, x: l @ x)

    def raw(self, trips):
        out = []
        for q in range(0, len(trips), self.s):
            chunk = trips[q : q + self.s]
            L = np.zeros((self.s, self.s), np.float32)
            for r, (a, b, c) in enumerate(chunk):
                L[r, a], L[r, b], L[r, c] = 1, EPS, -1
            g = np.asarray(self.f(L, np.ones((self.s, self.d), np.float32)))
            out += [g[r] for r in range(len(chunk))]
        return out

    def query(self, trips):
        return [decode(v[self.col]) for v in self.raw(trips)]

    def run(self, a, v):
        L = np.zeros((self.s, self.s), np.float32)
        X = np.zeros((self.s, self.d), np.float32)
        L[0], X[:, self.col] = a, v
        return np.asarray(self.f(L, X))[0, self.col]


def gram_blocks(s: int, d: int, lanes: int):
    """The Gram kernel's block starts along lane 0: x starts a block where
    x and x + lanes join before the current block's first leaf joins them."""
    p = GramProbe(s, d)
    starts, x = [0], lanes
    while x + lanes < d:
        if p.query([(starts[-1], x, x + lanes)])[0] == "bc":
            earlier = (y for y in range(x - lanes + 1, x) if p.query([(starts[-1], y, y + lanes)])[0] == "bc")
            starts.append(next(earlier, x))
        x += lanes
    return starts


def lift_splits(s: int, d: int):
    """Runs of columns with the same chain starts t (a chain ends before t
    where t and t + 1 join before t - 1 does)."""
    raw = np.stack(LiftProbe(s, d).raw([(t - 1, t, t + 1) for t in range(1, s - 1)]))
    cut = raw == np.float32(2.0 ** -24)
    sig = [tuple(int(t + 1) for t in np.nonzero(cut[:, j])[0]) for j in range(d)]
    runs, j = [], 0
    while j < d:
        k = j
        while k < d and sig[k] == sig[j]:
            k += 1
        runs.append((j, k, sig[j]))
        j = k
    return runs


def openblas():
    import scipy

    return ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(scipy.__file__) + ".libs", "libscipy_openblas*.so"))[0])


class SgemvProbe:
    """OpenBLAS's sgemv 'T' (alpha 1, beta 0) of column 0 with lda > rows,
    as ``slarf`` calls it: KIND 4, 2 or 1 columns a kernel call."""

    def __init__(self, kind: str, m: int, lda: int):
        self.n, self.m, self.lda = {"4": 4, "2": 2, "1": 1}[kind], m, lda
        self.lib = openblas()

    def gemv(self, A, x):
        P, I = ctypes.POINTER(ctypes.c_float), lambda v: ctypes.byref(ctypes.c_int(v))
        buf = np.zeros((self.n, self.lda), np.float32)
        buf[:, : self.m] = A.T
        y = np.zeros(self.n, np.float32)
        self.lib.scipy_sgemv_(ctypes.c_char_p(b"T"), I(self.m), I(self.n), ctypes.byref(ctypes.c_float(1.0)),
                              buf.ctypes.data_as(P), I(self.lda), x.ctypes.data_as(P), I(1),
                              ctypes.byref(ctypes.c_float(0.0)), y.ctypes.data_as(P), I(1), ctypes.c_size_t(1))
        return y

    def query(self, trips):
        out = []
        for a, b, c in trips:
            A = np.zeros((self.m, self.n), np.float32)
            A[a, 0], A[b, 0], A[c, 0] = 1, EPS, -1
            out.append(decode(self.gemv(A, np.ones(self.m, np.float32))[0]))
        return out

    def run(self, a, v):
        A = np.zeros((self.m, self.n), np.float32)
        A[:, 0] = a
        return self.gemv(A, v)[0]


def sgemv_form(kind: str, m: int, lda: int) -> str:
    """A form in ``ops/eigh._FORMS``'s notation: the tree, then each row's join."""
    p = SgemvProbe(kind, m, lda)
    tree = build(p, list(range(m)))
    flags = ["-"] * m
    for (x, y), j in joins(tree, p.run, m).items():
        if len(j) != 1:
            raise RuntimeError(f"row {y}: the probes leave {j}")
        flags[y] = j
    return f"{show(tree)} {''.join(flags)}"


def check_slaed4(count: int, seed: int = 0) -> int:
    """ops/eigh._slaed4 (lanes) against scipy's slaed4 on random secular
    equations of 3-32 poles (some with tiny z); returns the roots that
    differ in any bit of delta, the root or info, and the roots checked."""
    import torch

    from tracking_tpu_torch.ops import eigh

    lib, rng = openblas(), np.random.default_rng(seed)
    P, I = ctypes.POINTER(ctypes.c_float), lambda v: ctypes.byref(ctypes.c_int(v))
    lanes, refs = [], []
    for t in range(count):
        d = np.unique(np.sort(rng.standard_normal(int(rng.integers(3, 33)))).astype(np.float32))
        n = len(d)
        if n < 3:
            continue
        z = rng.standard_normal(n).astype(np.float32)
        if t % 2:
            z = (z * (rng.random(n) < 0.5) + 1e-4 * rng.standard_normal(n)).astype(np.float32)
        z = (z / np.float32(np.sqrt(np.sum(z.astype(np.float64) ** 2)))).astype(np.float32)
        rho = np.float32(abs(rng.standard_normal()) * 2 + 0.05)
        for i in range(n):
            delta, dlam, info = np.zeros(n, np.float32), ctypes.c_float(0), ctypes.c_int(0)
            lib.scipy_slaed4_(I(n), I(i + 1), d.ctypes.data_as(P), z.ctypes.data_as(P), delta.ctypes.data_as(P),
                              ctypes.byref(ctypes.c_float(rho)), ctypes.byref(dlam), ctypes.byref(info))
            pad = np.concatenate([d, d[-1] + 1 + np.arange(32 - n, dtype=np.float32)])
            lanes.append((n, i, pad, np.pad(z, (0, 32 - n)), rho))
            refs.append((delta, np.float32(dlam.value), info.value))
    n_, i_, D, Z, r = zip(*lanes)
    delta, dlam, info = eigh._slaed4(torch.tensor(n_), torch.tensor(i_), torch.from_numpy(np.stack(D)),
                                     torch.from_numpy(np.stack(Z)), torch.tensor(r))
    bad = sum(not (np.array_equal(delta[k, : n_[k]].numpy(), dr) and dlam[k].item() == lr and info[k].item() == ir)
              for k, (dr, lr, ir) in enumerate(refs))
    return bad, len(refs)


def check_sstedc(n: int, count: int, seed: int = 0) -> int:
    """ops/eigh._sstedc against scipy's sstedc('I') on random tridiagonals
    (splits, repeated and tiny values among them); returns those that differ."""
    import torch

    from tracking_tpu_torch.ops import eigh

    lib, rng = openblas(), np.random.default_rng(seed)
    P, I = ctypes.POINTER(ctypes.c_float), lambda v: ctypes.byref(ctypes.c_int(v))
    ds, es = [], []
    for b in range(count):
        d, e = rng.standard_normal(n).astype(np.float32), rng.standard_normal(n - 1).astype(np.float32)
        if b % 4 == 1:
            e[rng.integers(0, n - 1, 3)] = 0
        if b % 4 == 2:
            d, e = np.round(d * 2) / 2, e * (rng.random(n - 1) < 0.3)
        if b % 4 == 3:
            d, e = d * 1e-5, e * 1e-8
        ds.append(d.astype(np.float32))
        es.append(e.astype(np.float32))
    w, Z, info = eigh._sstedc(torch.from_numpy(np.stack(ds)), torch.from_numpy(np.stack(es)))
    bad = 0
    for b in range(count):
        d, e = ds[b].copy(), es[b].copy()
        z = np.zeros((n, n), np.float32, order="F")
        lw, liw = 1 + 4 * n + n * n, 3 + 5 * n
        work, iwork, inf = np.zeros(lw, np.float32), np.zeros(liw, np.int32), ctypes.c_int(0)
        lib.scipy_sstedc_(ctypes.c_char_p(b"I"), I(n), d.ctypes.data_as(P), e.ctypes.data_as(P), z.ctypes.data_as(P),
                          I(n), work.ctypes.data_as(P), I(lw), iwork.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                          I(liw), ctypes.byref(inf), ctypes.c_size_t(1))
        bad += not (np.array_equal(w[b].numpy(), d) and np.array_equal(Z[b].numpy(), z) and inf.value == int(info[b]))
    return bad


def check_blas(seed: int = 0) -> None:
    """Which of the candidate orders OpenBLAS's srot and small sgemm take."""
    lib, rng = openblas(), np.random.default_rng(seed)
    P, I = ctypes.POINTER(ctypes.c_float), lambda v: ctypes.byref(ctypes.c_int(v))
    F = lambda v: ctypes.byref(ctypes.c_float(v))
    for n in (1, 8, 17, 31):
        x, y = rng.standard_normal(n).astype(np.float32), rng.standard_normal(n).astype(np.float32)
        c, s = np.float32(0.6), np.float32(0.8)
        xo, yo = x.copy(), y.copy()
        lib.scipy_srot_(I(n), x.ctypes.data_as(P), I(1), y.ctypes.data_as(P), I(1), F(c), F(s))
        fx = all(x[i] == fma(c, xo[i], np.float32(s * yo[i])) for i in range(n))
        fy = all(y[i] == fma(c, yo[i], -np.float32(s * xo[i])) for i in range(n))
        print(f"srot n={n}: x' = fma(c, x, s*y) {fx}, y' = fma(c, y, -(s*x)) {fy}")
    for m, k, n in ((1, 3, 5), (16, 16, 32), (13, 7, 20), (4, 32, 4)):
        A, B = rng.standard_normal((m, k)).astype(np.float32), rng.standard_normal((k, n)).astype(np.float32)
        a, b, cm = np.asfortranarray(A), np.asfortranarray(B), np.zeros((m, n), np.float32, order="F")
        lib.scipy_sgemm_(ctypes.c_char_p(b"N"), ctypes.c_char_p(b"N"), I(m), I(n), I(k), F(1.0), a.ctypes.data_as(P),
                         I(m), b.ctypes.data_as(P), I(k), F(0.0), cm.ctypes.data_as(P), I(m), ctypes.c_size_t(1),
                         ctypes.c_size_t(1))
        acc = np.zeros((m, n), np.float32)
        for q in range(k):
            acc = np.vectorize(fma)(A[:, q : q + 1], B[q : q + 1], acc).astype(np.float32)
        print(f"sgemm {m}x{n} over {k}: one FMA chain in order {np.array_equal(acc, cm)}")



def _i(v):
    return ctypes.byref(ctypes.c_int(v))


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def workspace(n: int) -> None:
    """ilaenv's block sizes on this host and the sormqr block ssyevd's
    workspace leaves (lwork 1 + 6n + 2n², of which n² + 4n + 1 reach sormtr)."""
    from tracking_tpu_torch.ops import eigh

    lib = openblas()
    lib.scipy_ilaenv_.restype = ctypes.c_int

    def ilaenv(ispec, name, opts, n1, n2=-1, n3=-1):
        return lib.scipy_ilaenv_(_i(ispec), ctypes.c_char_p(name.encode()), ctypes.c_char_p(opts.encode()), _i(n1),
                                 _i(n2), _i(n3), _i(-1), ctypes.c_size_t(len(name)), ctypes.c_size_t(len(opts)))

    v = [ctypes.c_int() for _ in range(3)]
    lib.scipy_ilaver_(*map(ctypes.byref, v))
    print(f"LAPACK {'.'.join(str(x.value) for x in v)}; ssytrd NB {ilaenv(1, 'SSYTRD', 'L', n)} NX "
          f"{ilaenv(3, 'SSYTRD', 'L', n)}; sormqr NB {ilaenv(1, 'SORMQR', 'LN', n - 1, n, n - 1)} NBMIN "
          f"{ilaenv(2, 'SORMQR', 'LN', n - 1, n, n - 1)}; SMLSIZ {ilaenv(9, 'SSTEDC', ' ', 0)}; sormqr's block "
          f"in ssyevd's workspace at n = {n}: {eigh._sormqr_nb(n)}")


class DotProbe:
    """OpenBLAS's sdot of n terms (x * 1)."""

    def __init__(self, n: int):
        from scipy.linalg import blas

        self.n, self.blas = n, blas

    def query(self, trips):
        out = []
        for a, b, c in trips:
            x = np.zeros(self.n, np.float32)
            x[a], x[b], x[c] = 1, EPS, -1
            out.append(decode(np.float32(self.blas.sdot(x, np.ones(self.n, np.float32)))))
        return out

    def run(self, a, v):
        return np.float32(self.blas.sdot(a.astype(np.float32), v.astype(np.float32)))


def _sgemv(trans, alpha, A, lda, x, beta, y):
    m, k = A.shape
    buf = np.zeros((k, lda), np.float32)
    buf[:, :m] = A.T
    y = y.copy()
    openblas().scipy_sgemv_(ctypes.c_char_p(trans.encode()), _i(m), _i(k), ctypes.byref(ctypes.c_float(alpha)),
                            _p(buf), _i(lda), _p(x), _i(1), ctypes.byref(ctypes.c_float(beta)), _p(y), _i(1),
                            ctypes.c_size_t(1))
    return y


class GemvNProbe:
    """Row ``r`` of sgemv 'N' (alpha -1, beta 1) over k columns: leaves the
    columns' products, then y as leaf k."""

    def __init__(self, m: int, k: int, r: int, lda: int):
        self.m, self.k, self.r, self.lda = m, k, r, lda

    def _call(self, a, x, yv):
        A = np.zeros((self.m, self.k), np.float32)
        A[self.r] = -a
        y = np.zeros(self.m, np.float32)
        y[self.r] = yv
        return _sgemv("N", -1.0, A, self.lda, x.astype(np.float32), 1.0, y)[self.r]

    def query(self, trips):
        out = []
        for a, b, c in trips:
            v = np.zeros(self.k + 1, np.float32)
            v[a], v[b], v[c] = 1, EPS, -1
            out.append(decode(self._call(v[: self.k], np.ones(self.k, np.float32), v[self.k])))
        return out

    def run(self, a, v):
        return self._call(a[: self.k], v[: self.k], np.float32(a[self.k] * v[self.k]))


class GemmProbe:
    """Output (r, c) of sgemm(TA, TB, alpha 1): leaves the k products, then C
    as leaf k where beta is 1."""

    def __init__(self, ta, tb, m, n, k, r, c, beta):
        self.ta, self.tb, self.m, self.n, self.k, self.r, self.c, self.beta = ta, tb, m, n, k, r, c, beta

    def _call(self, a_row, b_col, cval):
        m, n, k = self.m, self.n, self.k
        opa, opb, cm = np.zeros((m, k), np.float32), np.zeros((k, n), np.float32), np.zeros((m, n), np.float32)
        opa[self.r], opb[:, self.c], cm[self.r, self.c] = a_row, b_col, cval
        A = np.asfortranarray(opa.T if self.ta == "T" else opa)
        B = np.asfortranarray(opb.T if self.tb == "T" else opb)
        C = np.asfortranarray(cm)
        F = lambda v: ctypes.byref(ctypes.c_float(v))
        openblas().scipy_sgemm_(ctypes.c_char_p(self.ta.encode()), ctypes.c_char_p(self.tb.encode()), _i(m), _i(n),
                                _i(k), F(1.0), _p(A), _i(A.shape[0]), _p(B), _i(B.shape[0]), F(self.beta), _p(C),
                                _i(m), ctypes.c_size_t(1), ctypes.c_size_t(1))
        return np.float32(C[self.r, self.c])

    def leaves(self):
        return self.k + (1 if self.beta else 0)

    def query(self, trips):
        out = []
        for a, b, c in trips:
            v = np.zeros(self.leaves(), np.float32)
            v[a], v[b], v[c] = 1, EPS, -1
            out.append(decode(self._call(v[: self.k], np.ones(self.k, np.float32), v[self.k] if self.beta else 0)))
        return out

    def run(self, a, v):
        return self._call(a[: self.k], v[: self.k], np.float32(a[self.k] * v[self.k]) if self.beta else 0)


def _tree_and_joins(p, n_leaves):
    tree = build(p, list(range(n_leaves)))
    print(show(tree))
    print(sorted(joins(tree, p.run, n_leaves).items()))


def check_ssytrd(n: int, count: int, seed: int = 0) -> int:
    """ops/eigh._ssytrd against scipy's ssytrd (ssyevd's workspace) on Gram
    matrices: the matrices whose d, e, tau or reflectors differ."""
    import torch
    from scipy.linalg import lapack

    from tracking_tpu_torch.ops import eigh

    rng = np.random.default_rng(seed)
    gs = []
    for _ in range(count):
        x = rng.standard_normal((n, 3 * n)).astype(np.float32)
        gs.append((x @ x.T).astype(np.float32))
    A, d, e, tau = eigh._ssytrd(torch.from_numpy(np.stack(gs)))
    low = np.tril(np.ones((n, n), bool))
    bad = 0
    for b, g in enumerate(gs):
        c, dr, er, tr, _ = lapack.ssytrd(g, lower=1, lwork=2 * n * n + 4 * n + 1)
        bad += not (np.array_equal(A[b].numpy()[low], c[low]) and np.array_equal(d[b].numpy(), dr)
                    and np.array_equal(e[b].numpy(), er) and np.array_equal(tau[b].numpy(), tr))
    return bad


def check_sormtr(n: int, count: int, seed: int = 0) -> int:
    """ops/eigh._sormtr against OpenBLAS's sormqr called as ssyevd's sormtr
    calls it (lda = ldc = n, lwork n² + 4n + 1) on random Z."""
    import torch
    from scipy.linalg import lapack

    from tracking_tpu_torch.ops import eigh

    lib, rng, bad = openblas(), np.random.default_rng(seed), 0
    for _ in range(count):
        x = rng.standard_normal((n, 3 * n)).astype(np.float32)
        c, _, _, tr, _ = lapack.ssytrd((x @ x.T).astype(np.float32), lower=1, lwork=2 * n * n + 4 * n + 1)
        z = rng.standard_normal((n, n)).astype(np.float32)
        af, cf = np.array(c, np.float32, order="F"), np.array(z, np.float32, order="F")
        lw = n * n + 4 * n + 1
        work, info = np.zeros(lw, np.float32), ctypes.c_int(0)
        lib.scipy_sormqr_(ctypes.c_char_p(b"L"), ctypes.c_char_p(b"N"), _i(n - 1), _i(n), _i(n - 1),
                          ctypes.c_void_p(af.ctypes.data + 4), _i(n), _p(tr), ctypes.c_void_p(cf.ctypes.data + 4),
                          _i(n), _p(work), _i(lw), ctypes.byref(info), ctypes.c_size_t(1), ctypes.c_size_t(1))
        got = eigh._sormtr(torch.from_numpy(c)[None], torch.from_numpy(tr)[None], torch.from_numpy(z)[None])[0]
        bad += not np.array_equal(got.numpy(), cf)
    return bad


def _lane_plans(s: int, depth: int):
    """Candidate orders of a sum over ``depth`` terms: one chain (c), 2 or 4
    FMA lanes with the rest as rounded products."""
    from tracking_tpu_torch.ops.contract import Plan

    out = {"c": Plan(((0, depth),))}
    for lanes in (2, 4):
        main = depth - depth % lanes
        if main:
            out[str(lanes)] = Plan(((0, main),) + (((main, depth),) if depth > main else ()), lanes=lanes)
    return out


def kinds(what: str, s0: int, s1: int, ds, trials: int = 4, seed: int = 0) -> None:
    """For each S and D, the candidate orders every output of the Gram
    product (``gram``) or of the lift (``lift``) equals on random data."""
    import jax
    import torch

    from tracking_tpu_torch.ops.contract import contract

    rng = np.random.default_rng(seed)
    gram, lift = jax.jit(lambda x: x @ x.T), jax.jit(lambda l, x: l @ x)
    for s in range(s0, s1 + 1):
        row = []
        for d in ds:
            plans = _lane_plans(s, d if what == "gram" else s)
            ok = dict.fromkeys(plans, True)
            for _ in range(trials):
                x = rng.standard_normal((s, d)).astype(np.float32)
                X = torch.from_numpy(x)
                if what == "gram":
                    ref, args = np.asarray(gram(x)), (X, X.T)
                else:
                    l = rng.standard_normal((s, s)).astype(np.float32)
                    ref, args = np.asarray(lift(l, x)), (torch.from_numpy(l), X)
                for k, p in plans.items():
                    ok[k] = ok[k] and bool((contract(*args, p).numpy() == ref).all())
            row.append(f"{d}:{'/'.join(k for k in plans if ok[k]) or 'X'}")
        print(s, " ".join(row), flush=True)


def main(argv) -> None:
    cmd = argv[0]
    args = [int(a) for a in argv[1:]] if cmd not in ("sgemm", "gram-kinds", "lift-kinds") else []
    if cmd == "gram":
        p = GramProbe(*args)
        tree = build(p, list(range(args[1])))
        print(show(tree))
        print(sorted(joins(tree, p.run, args[1]).items()))
    elif cmd == "gram-blocks":
        from tracking_tpu_torch.ops.contract import gram_lanes

        print(gram_blocks(args[0], args[1], gram_lanes(*args)))
    elif cmd == "lift":
        for col in args[2:] or [0]:
            p = LiftProbe(args[0], args[1], col)
            tree = build(p, list(range(args[0])))
            print(col, show(tree), sorted(joins(tree, p.run, args[0]).items()))
    elif cmd == "lift-splits":
        for a, b, t in lift_splits(*args):
            print(f"columns {a}-{b - 1}: chains start at 0, {', '.join(map(str, t))}")
    elif cmd == "sgemv":
        print(sgemv_form(argv[1], args[1], args[2] if len(args) > 2 else 32))
    elif cmd == "slaed4":
        print("roots that differ, of all: %d of %d" % check_slaed4(args[0] if args else 400))
    elif cmd == "sstedc":
        print("matrices that differ:", check_sstedc(args[0], args[1] if len(args) > 1 else 100))
    elif cmd == "blas":
        check_blas()
    elif cmd == "workspace":
        workspace(args[0])
    elif cmd == "sdot":
        _tree_and_joins(DotProbe(args[0]), args[0])
    elif cmd == "sgemv-n":
        _tree_and_joins(GemvNProbe(args[0], args[1], args[2], args[3] if len(args) > 3 else 64), args[1] + 1)
    elif cmd == "sgemm":
        m, n, k, r, c = (int(a) for a in argv[3:8])
        p = GemmProbe(argv[1], argv[2], m, n, k, r, c, float(argv[8]) if len(argv) > 8 else 0.0)
        _tree_and_joins(p, p.leaves())
    elif cmd == "ssytrd":
        print("matrices that differ:", check_ssytrd(args[0], args[1] if len(args) > 1 else 12))
    elif cmd == "sormtr":
        print("matrices that differ:", check_sormtr(args[0], args[1] if len(args) > 1 else 12))
    elif cmd in ("gram-kinds", "lift-kinds"):
        kinds(cmd.split("-")[0], int(argv[1]), int(argv[2]), [int(d) for d in argv[3].split(",")])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
