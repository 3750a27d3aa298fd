"""LAPACK's ``ssyevd`` for n <= 25 as jaxlib runs it on the test host, in its
own order of operations: the eigensolver of ``jnp.linalg.eigh`` (one
custom call, ``lapack_ssyevd_ffi``, into scipy's OpenBLAS 0.3.30 with its
SkylakeX kernels).

For n <= 25 (LAPACK's SMLSIZ) ``ssyevd`` is: ``slansy``'s scaling test
(and ``slascl`` of the lower triangle where the norm is below sqrt(2^-103)
or above its inverse); ``ssytrd``, which for n < 32 is ``ssytd2``
(``slarfg`` with OpenBLAS's ``snrm2``, then ``ssymv``, ``sdot``,
``saxpy`` and ``ssyr2``); ``sstedc``, which for n <= 25 is ``ssteqr``
(implicit QL / QR with ``slaev2``, ``slartg``, ``slapy2``, ``slascl`` of
each block outside [2^-15, 2^63/3], at most 30 n sweeps, the final
selection sort); ``sormtr`` = ``sorm2r`` (``slarf``: ``sgemv`` 'T' and
``sger``). The Fortran is reference LAPACK built without FMA contraction;
OpenBLAS's kernels fuse where they do. Found against ``scipy.linalg.blas``
and ``scipy.linalg.lapack`` (each routine, then the whole ``ssyevd`` on
10^5 seeded matrices, every bit of eigenvalues and eigenvectors):

- ``snrm2``: the f32 squares summed in f64, the f64 root rounded to f32.
- ``sdot``: the f32 products summed in f64 in index order, rounded.
- ``saxpy``, ``sger`` (a column at a time, ``alpha·y[j]`` rounded first),
  ``ssyr2`` (lower: a column c gets ``x[c]`` then ``y[c]`` times the other
  vector, each an axpy): one FMA an element.
- ``ssymv`` lower (:func:`_symv`): columns in blocks of 4 (the rest one at
  a time): the block's diagonal and its triangle, then, where at least 12
  rows lie below the block, the rows to the last multiple of 4 with ``y``
  an FMA chain over the 4 columns and each column's dot in 4 lanes (rows
  mod 4) added ((l0 + l1) + (l2 + l3)), then the rows left over one by
  one; each column's dot added to ``y`` by one FMA with alpha.
- ``sgemv`` 'T' (:func:`_gemv_t`, ``lda`` > rows as in ``slarf``):
  columns in groups of 4, then a pair, then one, each group's kernel adds
  a column's products in the tree :data:`_FORMS` gives for its row count,
  a product joining a sum either by an FMA ("F"), rounded then added
  ("M"), or (a pair, "R") the higher row's product rounded and the lower
  one fused onto it. Read off three-leaf probes (which pair is added
  first) and two-leaf probes (which rounding) of OpenBLAS's own ``sgemv``.

:func:`syevd_ref` is the plain version, vectorised over a batch of
matrices (the QL / QR sweeps run as a loop of events, every matrix taking
its own next step). On CUDA tensors :func:`syevd` launches
``syevd_small`` (``csrc/pca.cu``): one thread a matrix, the same
arithmetic in LAPACK's scalar order.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tracking_tpu_torch.ops import _native, xla_math

_F32 = torch.float32
NMAX = 25  # LAPACK's SMLSIZ: above it ssyevd divides and conquers (not reproduced)

# "kind:rows" -> "tree flags": the sum of OpenBLAS's sgemv 'T' kernels
# (kind 4, 2 or 1 columns at once) over ``rows`` products; the flag of row
# r says how its product joins the sum ("-": it starts a sum).
_FORMS = {
    "4:1": "0 -",
    "4:2": "(0+1) -R",
    "4:3": "(2+(0+1)) -RF",
    "4:4": "((0+1)+(2+3)) -M-M",
    "4:5": "(4+((0+1)+(2+3))) -M-MF",
    "4:6": "((4+5)+((0+1)+(2+3))) -M-M-R",
    "4:7": "((6+(4+5))+((0+1)+(2+3))) -M-M-RF",
    "4:8": "(((0+4)+(1+5))+((2+6)+(3+7))) ----MMMM",
    "4:9": "(8+(((0+4)+(1+5))+((2+6)+(3+7)))) ----MMMMF",
    "4:10": "((8+9)+(((0+4)+(1+5))+((2+6)+(3+7)))) ----MMMM-R",
    "4:11": "((10+(8+9))+(((0+4)+(1+5))+((2+6)+(3+7)))) ----MMMM-RF",
    "4:12": "(((8+(0+4))+(9+(1+5)))+((10+(2+6))+(11+(3+7)))) ----FFFFMMMM",
    "4:13": "(12+(((8+(0+4))+(9+(1+5)))+((10+(2+6))+(11+(3+7))))) ----FFFFMMMMF",
    "4:14": "((12+13)+(((8+(0+4))+(9+(1+5)))+((10+(2+6))+(11+(3+7))))) ----FFFFMMMM-R",
    "4:15": "((14+(12+13))+(((8+(0+4))+(9+(1+5)))+((10+(2+6))+(11+(3+7))))) ----FFFFMMMM-RF",
    "4:16": "((((0+8)+(4+12))+((1+9)+(5+13)))+(((2+10)+(6+14))+((3+11)+(7+15)))) --------FFFFFFFF",
    "4:17": "(16+((((0+8)+(4+12))+((1+9)+(5+13)))+(((2+10)+(6+14))+((3+11)+(7+15))))) --------FFFFFFFFF",
    "4:18": "((16+17)+((((0+8)+(4+12))+((1+9)+(5+13)))+(((2+10)+(6+14))+((3+11)+(7+15))))) --------FFFFFFFF-R",
    "4:19": "((18+(16+17))+((((0+8)+(4+12))+((1+9)+(5+13)))+(((2+10)+(6+14))+((3+11)+(7+15))))) --------FFFFFFFF-RF",
    "4:20": "((((8+16)+(12+(0+4)))+((9+17)+(13+(1+5))))+(((10+18)+(14+(2+6)))+((11+19)+(15+(3+7))))) ----FFFF----FFFFFFFF",
    "4:21": "(20+((((8+16)+(12+(0+4)))+((9+17)+(13+(1+5))))+(((10+18)+(14+(2+6)))+((11+19)+(15+(3+7)))))) ----FFFF----FFFFFFFFF",
    "4:22": "((20+21)+((((8+16)+(12+(0+4)))+((9+17)+(13+(1+5))))+(((10+18)+(14+(2+6)))+((11+19)+(15+(3+7)))))) ----FFFF----FFFFFFFF-R",
    "4:23": "((22+(20+21))+((((8+16)+(12+(0+4)))+((9+17)+(13+(1+5))))+(((10+18)+(14+(2+6)))+((11+19)+(15+(3+7)))))) ----FFFF----FFFFFFFF-RF",
    "4:24": "((((16+(0+8))+(20+(4+12)))+((17+(1+9))+(21+(5+13))))+(((18+(2+10))+(22+(6+14)))+((19+(3+11))+(23+(7+15))))) --------FFFFFFFFFFFFFFFF",
    "4:25": "(24+((((16+(0+8))+(20+(4+12)))+((17+(1+9))+(21+(5+13))))+(((18+(2+10))+(22+(6+14)))+((19+(3+11))+(23+(7+15)))))) --------FFFFFFFFFFFFFFFFF",
    "2:1": "0 -",
    "2:2": "(0+1) -R",
    "2:3": "(2+(0+1)) -RF",
    "2:4": "((0+1)+(2+3)) -M-M",
    "2:5": "(4+((0+1)+(2+3))) -M-MF",
    "2:6": "((4+5)+((0+1)+(2+3))) -M-M-R",
    "2:7": "((6+(4+5))+((0+1)+(2+3))) -M-M-RF",
    "2:8": "(((0+4)+(1+5))+((2+6)+(3+7))) ----MMMM",
    "2:9": "(8+(((0+4)+(1+5))+((2+6)+(3+7)))) ----MMMMF",
    "2:10": "((8+9)+(((0+4)+(1+5))+((2+6)+(3+7)))) ----MMMM-R",
    "2:11": "((10+(8+9))+(((0+4)+(1+5))+((2+6)+(3+7)))) ----MMMM-RF",
    "2:12": "(((8+(0+4))+(9+(1+5)))+((10+(2+6))+(11+(3+7)))) ----MMMMMMMM",
    "2:13": "(12+(((8+(0+4))+(9+(1+5)))+((10+(2+6))+(11+(3+7))))) ----MMMMMMMMF",
    "2:14": "((12+13)+(((8+(0+4))+(9+(1+5)))+((10+(2+6))+(11+(3+7))))) ----MMMMMMMM-R",
    "2:15": "((14+(12+13))+(((8+(0+4))+(9+(1+5)))+((10+(2+6))+(11+(3+7))))) ----MMMMMMMM-RF",
    "2:16": "(((12+(8+(0+4)))+(13+(9+(1+5))))+((14+(10+(2+6)))+(15+(11+(3+7))))) ----MMMMMMMMMMMM",
    "2:17": "(16+(((12+(8+(0+4)))+(13+(9+(1+5))))+((14+(10+(2+6)))+(15+(11+(3+7)))))) ----MMMMMMMMMMMMF",
    "2:18": "((16+17)+(((12+(8+(0+4)))+(13+(9+(1+5))))+((14+(10+(2+6)))+(15+(11+(3+7)))))) ----MMMMMMMMMMMM-R",
    "2:19": "((18+(16+17))+(((12+(8+(0+4)))+(13+(9+(1+5))))+((14+(10+(2+6)))+(15+(11+(3+7)))))) ----MMMMMMMMMMMM-RF",
    "2:20": "(((16+(12+(8+(0+4))))+(17+(13+(9+(1+5)))))+((18+(14+(10+(2+6))))+(19+(15+(11+(3+7)))))) ----MMMMMMMMMMMMMMMM",
    "2:21": "(20+(((16+(12+(8+(0+4))))+(17+(13+(9+(1+5)))))+((18+(14+(10+(2+6))))+(19+(15+(11+(3+7))))))) ----MMMMMMMMMMMMMMMMF",
    "2:22": "((20+21)+(((16+(12+(8+(0+4))))+(17+(13+(9+(1+5)))))+((18+(14+(10+(2+6))))+(19+(15+(11+(3+7))))))) ----MMMMMMMMMMMMMMMM-R",
    "2:23": "((22+(20+21))+(((16+(12+(8+(0+4))))+(17+(13+(9+(1+5)))))+((18+(14+(10+(2+6))))+(19+(15+(11+(3+7))))))) ----MMMMMMMMMMMMMMMM-RF",
    "2:24": "(((20+(16+(12+(8+(0+4)))))+(21+(17+(13+(9+(1+5))))))+((22+(18+(14+(10+(2+6)))))+(23+(19+(15+(11+(3+7))))))) ----MMMMMMMMMMMMMMMMMMMM",
    "2:25": "(24+(((20+(16+(12+(8+(0+4)))))+(21+(17+(13+(9+(1+5))))))+((22+(18+(14+(10+(2+6)))))+(23+(19+(15+(11+(3+7)))))))) ----MMMMMMMMMMMMMMMMMMMMF",
    "1:1": "0 -",
    "1:2": "(0+1) -R",
    "1:3": "(2+(0+1)) -RF",
    "1:4": "((0+1)+(2+3)) -M-M",
    "1:5": "(4+((0+1)+(2+3))) -M-MF",
    "1:6": "((4+5)+((0+1)+(2+3))) -M-M-R",
    "1:7": "((6+(4+5))+((0+1)+(2+3))) -M-M-RF",
    "1:8": "(((0+4)+(1+5))+((2+6)+(3+7))) ----MMMM",
    "1:9": "(8+(((0+4)+(1+5))+((2+6)+(3+7)))) ----MMMMF",
    "1:10": "((8+9)+(((0+4)+(1+5))+((2+6)+(3+7)))) ----MMMM-R",
    "1:11": "((10+(8+9))+(((0+4)+(1+5))+((2+6)+(3+7)))) ----MMMM-RF",
    "1:12": "(((8+(0+4))+(9+(1+5)))+((10+(2+6))+(11+(3+7)))) ----MMMMMMMM",
    "1:13": "(12+(((8+(0+4))+(9+(1+5)))+((10+(2+6))+(11+(3+7))))) ----MMMMMMMMF",
    "1:14": "((12+13)+(((8+(0+4))+(9+(1+5)))+((10+(2+6))+(11+(3+7))))) ----MMMMMMMM-R",
    "1:15": "((14+(12+13))+(((8+(0+4))+(9+(1+5)))+((10+(2+6))+(11+(3+7))))) ----MMMMMMMM-RF",
    "1:16": "((((0+8)+(4+12))+((1+9)+(5+13)))+(((2+10)+(6+14))+((3+11)+(7+15)))) --------MMMMMMMM",
    "1:17": "(16+((((0+8)+(4+12))+((1+9)+(5+13)))+(((2+10)+(6+14))+((3+11)+(7+15))))) --------MMMMMMMMF",
    "1:18": "((16+17)+((((0+8)+(4+12))+((1+9)+(5+13)))+(((2+10)+(6+14))+((3+11)+(7+15))))) --------MMMMMMMM-R",
    "1:19": "((18+(16+17))+((((0+8)+(4+12))+((1+9)+(5+13)))+(((2+10)+(6+14))+((3+11)+(7+15))))) --------MMMMMMMM-RF",
    "1:20": "((((8+16)+(12+(0+4)))+((9+17)+(13+(1+5))))+(((10+18)+(14+(2+6)))+((11+19)+(15+(3+7))))) ----MMMM----MMMMMMMM",
    "1:21": "(20+((((8+16)+(12+(0+4)))+((9+17)+(13+(1+5))))+(((10+18)+(14+(2+6)))+((11+19)+(15+(3+7)))))) ----MMMM----MMMMMMMMF",
    "1:22": "((20+21)+((((8+16)+(12+(0+4)))+((9+17)+(13+(1+5))))+(((10+18)+(14+(2+6)))+((11+19)+(15+(3+7)))))) ----MMMM----MMMMMMMM-R",
    "1:23": "((22+(20+21))+((((8+16)+(12+(0+4)))+((9+17)+(13+(1+5))))+(((10+18)+(14+(2+6)))+((11+19)+(15+(3+7)))))) ----MMMM----MMMMMMMM-RF",
    "1:24": "((((16+(0+8))+(20+(4+12)))+((17+(1+9))+(21+(5+13))))+(((18+(2+10))+(22+(6+14)))+((19+(3+11))+(23+(7+15))))) --------MMMMMMMMMMMMMMMM",
    "1:25": "(24+((((16+(0+8))+(20+(4+12)))+((17+(1+9))+(21+(5+13))))+(((18+(2+10))+(22+(6+14)))+((19+(3+11))+(23+(7+15)))))) --------MMMMMMMMMMMMMMMMF",
}

_PROD, _FMA, _MADD, _ADD = 0, 1, 2, 3


def _parse(s: str):
    if s[0] != "(":
        return int(s)
    depth = 0
    for i, ch in enumerate(s[1:-1], 1):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "+" and depth == 0:
            return (_parse(s[1:i]), _parse(s[i + 1 : -1]))
    raise ValueError(s)


@lru_cache(maxsize=None)
def _program(kind: str, rows: int) -> tuple:
    """The postfix program of a sgemv 'T' form: (op, row) pairs over a
    stack of partial sums (PROD pushes a rounded product, FMA and MADD join
    a product to the top, ADD adds the top two)."""
    tree, flags = _FORMS[f"{kind}:{rows}"].split(" ")
    out = []

    def emit(node):
        if isinstance(node, int):
            out.append((_PROD, node))
            return
        x, y = node
        if isinstance(x, int) and isinstance(y, int):
            lo, hi = min(x, y), max(x, y)
            if flags[hi] == "R":
                out.extend([(_PROD, hi), (_FMA, lo)])
            else:
                out.extend([(_PROD, lo), (_FMA if flags[hi] == "F" else _MADD, hi)])
        elif isinstance(x, int) or isinstance(y, int):
            leaf, sub = (x, y) if isinstance(x, int) else (y, x)
            emit(sub)
            out.append((_FMA if flags[leaf] == "F" else _MADD, leaf))
        else:
            emit(x)
            emit(y)
            out.append((_ADD, 0))

    emit(_parse(tree))
    return tuple(out)


def _kinds(n: int) -> list:
    """The sgemv 'T' kernel of each of n columns: groups of 4, a pair, one."""
    n4 = n - n % 4
    return ["4"] * n4 + (["2", "2"] if n % 4 & 2 else []) + (["1"] if n % 4 & 1 else [])


def _fma(a, b, c):
    return xla_math.fma(a, b, c)


def _gemv_t(C: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """OpenBLAS's sgemv 'T' with alpha 1, beta 0: C [B, m, n], v [B, m] -> [B, n]."""
    m, n = C.shape[1], C.shape[2]
    ks = _kinds(n)
    out = torch.empty((C.shape[0], n), dtype=_F32, device=C.device)
    for kind in sorted(set(ks)):
        cols = [j for j in range(n) if ks[j] == kind]
        a = C[:, :, cols]  # [B, m, c]
        stack = []
        for op, r in _program(kind, m):
            if op == _PROD:
                stack.append(a[:, r] * v[:, r : r + 1])
            elif op == _FMA:
                stack.append(_fma(a[:, r], v[:, r : r + 1], stack.pop()))
            elif op == _MADD:
                stack.append(stack.pop() + a[:, r] * v[:, r : r + 1])
            else:
                y = stack.pop()
                stack.append(stack.pop() + y)
        out[:, cols] = stack.pop()
    return out


def _sqrt(x):
    return xla_math.sqrt(x)


def _f32_sqrt(x: float) -> float:
    """The correctly rounded f32 root of an f32 constant (Fortran's SQRT)."""
    return float(np.sqrt(np.float32(x)))


def _slapy2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xa, ya = x.abs(), y.abs()
    w, z = torch.maximum(xa, ya), torch.minimum(xa, ya)
    q = z / torch.where(w == 0, 1.0, w)
    r = w * _sqrt(1.0 + q * q)
    r = torch.where((z == 0) | (w > torch.finfo(_F32).max), w, r)
    r = torch.where(torch.isnan(y), y, r)
    return torch.where(torch.isnan(x), x, r)


def _snrm2(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k].double() * x[:, k].double()
    return acc.sqrt().to(_F32)


def _sdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
    for k in range(x.shape[1]):
        acc = acc + (x[:, k] * y[:, k]).double()
    return acc.to(_F32)


_SAFMIN = 2.0 ** -126
_LARFG_MIN = 2.0 ** -102  # slamch('S') / slamch('E')


def _slarfg(alpha: torch.Tensor, x: torch.Tensor):
    """(beta, tau, v) of LAPACK's slarfg over batches; alpha [B], x [B, k]."""
    if x.shape[1] == 0:
        return alpha, torch.zeros_like(alpha), x
    xnorm = _snrm2(x)
    live = xnorm != 0
    beta = -torch.copysign(_slapy2(alpha, xnorm), alpha)
    knt = torch.zeros(alpha.shape, dtype=torch.int64, device=alpha.device)
    small = live & (beta.abs() < _LARFG_MIN)
    if small.any():
        go = small.clone()
        for _ in range(20):
            knt = knt + go.long()
            x = torch.where(go[:, None], x * 2.0 ** 102, x)
            beta = torch.where(go, beta * 2.0 ** 102, beta)
            alpha = torch.where(go, alpha * 2.0 ** 102, alpha)
            go = go & (beta.abs() < _LARFG_MIN) & (knt < 20)
            if not go.any():
                break
        beta = torch.where(small, -torch.copysign(_slapy2(alpha, _snrm2(x)), alpha), beta)
    tau = (beta - alpha) / beta
    v = x * (1.0 / (alpha - beta))[:, None]
    for k in range(int(knt.max())):
        beta = torch.where(knt > k, beta * _LARFG_MIN, beta)
    return (torch.where(live, beta, alpha), torch.where(live, tau, torch.zeros_like(tau)),
            torch.where(live[:, None], v, x))


def _symv(alpha: torch.Tensor, S: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenBLAS's ssymv, lower, beta 0: alpha [B], S [B, k, k], x [B, k]."""
    k = x.shape[1]
    y = torch.zeros_like(x)
    o1 = k // 4 * 4
    for j in range(0, o1, 4):
        t1 = alpha[:, None] * x[:, j : j + 4]
        t2 = [torch.zeros_like(alpha) for _ in range(4)]
        for c in range(4):
            y[:, j + c] = _fma(t1[:, c], S[:, j + c, j + c], y[:, j + c])
        for c in range(3):
            for i in range(j + c + 1, j + 4):
                y[:, i] = _fma(t1[:, c], S[:, i, j + c], y[:, i])
                t2[c] = _fma(S[:, i, j + c], x[:, i], t2[c])
        if k - (j + 1) >= 12 and o1 > j + 4:
            for c in range(4):
                y[:, j + 4 : o1] = _fma(t1[:, c : c + 1], S[:, j + 4 : o1, j + c], y[:, j + 4 : o1])
            for c in range(4):
                lanes = torch.zeros((x.shape[0], 4), dtype=_F32, device=x.device)
                for r in range(j + 4, o1, 4):
                    lanes = _fma(S[:, r : r + 4, j + c], x[:, r : r + 4], lanes)
                t2[c] = t2[c] + ((lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3]))
            rest = range(o1, k)
        else:
            rest = range(j + 4, k)
        for i in rest:
            for c in range(4):
                y[:, i] = _fma(t1[:, c], S[:, i, j + c], y[:, i])
                t2[c] = _fma(S[:, i, j + c], x[:, i], t2[c])
        for c in range(4):
            y[:, j + c] = _fma(alpha, t2[c], y[:, j + c])
    for j in range(o1, k):
        t1 = alpha * x[:, j]
        t2 = torch.zeros_like(alpha)
        y[:, j] = _fma(t1, S[:, j, j], y[:, j])
        for i in range(j + 1, k):
            y[:, i] = _fma(t1, S[:, i, j], y[:, i])
            t2 = _fma(S[:, i, j], x[:, i], t2)
        y[:, j] = _fma(alpha, t2, y[:, j])
    return y


def _ssytd2(A: torch.Tensor):
    """LAPACK's ssytd2, lower, over a batch [B, n, n] -> (A, d, e, tau)."""
    A = A.clone()
    B, n = A.shape[0], A.shape[1]
    d = torch.empty((B, n), dtype=_F32, device=A.device)
    e = torch.zeros((B, max(n - 1, 0)), dtype=_F32, device=A.device)
    tau = torch.zeros((B, max(n - 1, 0)), dtype=_F32, device=A.device)
    for i in range(n - 1):
        beta, taui, v = _slarfg(A[:, i + 1, i], A[:, i + 2 :, i])
        A[:, i + 2 :, i] = v
        e[:, i] = beta
        live = taui != 0
        if live.any():
            vv = torch.cat([torch.ones_like(beta)[:, None], v], 1)
            S = A[:, i + 1 :, i + 1 :]
            w = _symv(taui, S, vv)
            alph = (-0.5 * taui) * _sdot(w, vv)
            w = _fma(alph[:, None], vv, w)
            S2 = S.clone()
            m = vv.shape[1]
            for c in range(m):
                S2[:, c:, c] = _fma(-vv[:, c : c + 1], w[:, c:], S2[:, c:, c])
                S2[:, c:, c] = _fma(-w[:, c : c + 1], vv[:, c:], S2[:, c:, c])
            A[:, i + 1 :, i + 1 :] = torch.where(live[:, None, None], S2, S)
        A[:, i + 1, i] = beta
        d[:, i] = A[:, i, i]
        tau[:, i] = taui
    d[:, n - 1] = A[:, n - 1, n - 1]
    return A, d, e, tau


def _slascl_steps(cfrom: torch.Tensor, cto: torch.Tensor, active: torch.Tensor):
    """LAPACK's slascl as a list of (multiplier, mask) steps over a batch."""
    small = _SAFMIN
    big = 1.0 / small
    cf, ct = cfrom.clone(), cto.clone()
    pending = active.clone()
    steps = []
    for _ in range(16):
        if not pending.any():
            break
        cf1 = cf * small
        ct1 = ct / big
        inf = cf1 == cf
        c2 = ~inf & (ct1 == ct)
        c3 = ~inf & ~c2 & (cf1.abs() > ct.abs()) & (ct != 0)
        c4 = ~inf & ~c2 & ~c3 & (ct1.abs() > cf.abs())
        c5 = ~inf & ~c2 & ~c3 & ~c4
        mul = torch.where(inf | c5, ct / cf, torch.where(c2, ct, torch.where(c3, torch.full_like(ct, small),
                                                                              torch.full_like(ct, big))))
        apply = pending & ~(c5 & (mul == 1.0))
        steps.append((mul, apply))
        cf = torch.where(pending & c3, cf1, torch.where(pending & c2, torch.ones_like(cf), cf))
        ct = torch.where(pending & c4, ct1, ct)
        pending = pending & (c3 | c4)
    return steps


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b] - 1] (1-based positions, clamped)."""
    return x.gather(1, (idx - 1).clamp(0, x.shape[1] - 1)[:, None])[:, 0]


def _put(x: torch.Tensor, idx: torch.Tensor, val, mask: torch.Tensor) -> torch.Tensor:
    """x with x[b, idx[b] - 1] = val[b] where mask[b]."""
    pos = torch.arange(1, x.shape[1] + 1, device=x.device)[None]
    if not isinstance(val, torch.Tensor):
        val = torch.full(x.shape[:1], val, dtype=x.dtype, device=x.device)
    return torch.where(mask[:, None] & (pos == idx[:, None]), val[:, None], x)


def _rotate(Z: torch.Tensor, j: torch.Tensor, c: torch.Tensor, s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """slasr's plane (j, j + 1) (1-based columns) of Z [B, n, n] where mask."""
    n = Z.shape[2]
    i0 = (j - 1).clamp(0, n - 1)
    i1 = j.clamp(0, n - 1)
    zj = Z.gather(2, i0[:, None, None].expand(-1, n, 1))[:, :, 0]
    temp = Z.gather(2, i1[:, None, None].expand(-1, n, 1))[:, :, 0]
    new1 = c[:, None] * temp - s[:, None] * zj
    new0 = s[:, None] * temp + c[:, None] * zj
    col = torch.arange(n, device=Z.device)[None, None]
    m = mask[:, None, None]
    Z = torch.where(m & (col == i1[:, None, None]), new1[:, :, None], Z)
    return torch.where(m & (col == i0[:, None, None]), new0[:, :, None], Z)


def _slartg(f: torch.Tensor, g: torch.Tensor):
    rtmin = 2.0 ** -63
    rtmax = _f32_sqrt(2.0 ** 125)
    f1, g1 = f.abs(), g.abs()
    mid = (f1 > rtmin) & (f1 < rtmax) & (g1 > rtmin) & (g1 < rtmax)
    u = torch.clamp(torch.maximum(f1, g1), min=_SAFMIN, max=2.0 ** 126)
    u = torch.where(mid, torch.ones_like(u), u)
    fs, gs = f / u, g / u
    dd = _sqrt(fs * fs + gs * gs)
    c = fs.abs() / dd
    r = torch.copysign(dd, f)
    s = gs / r
    r = torch.where(mid, r, r * u)
    one, zero = torch.ones_like(f), torch.zeros_like(f)
    c = torch.where(f == 0, zero, c)
    s = torch.where(f == 0, torch.copysign(one, g), s)
    r = torch.where(f == 0, g1, r)
    c = torch.where(g == 0, one, c)
    s = torch.where(g == 0, zero, s)
    r = torch.where(g == 0, f, r)
    return c, s, r


def _slaev2(a, b, c):
    sm = a + c
    df = a - c
    adf = df.abs()
    tb = b + b
    ab = tb.abs()
    big = a.abs() > c.abs()
    acmx, acmn = torch.where(big, a, c), torch.where(big, c, a)
    q1 = ab / torch.where(adf == 0, 1.0, adf)
    q2 = adf / torch.where(ab == 0, 1.0, ab)
    rt = torch.where(adf > ab, adf * _sqrt(1.0 + q1 * q1),
                     torch.where(adf < ab, ab * _sqrt(1.0 + q2 * q2), ab * _f32_sqrt(2.0)))
    rt1 = torch.where(sm < 0, 0.5 * (sm - rt), torch.where(sm > 0, 0.5 * (sm + rt), 0.5 * rt))
    safe = torch.where(rt1 == 0, 1.0, rt1)
    rt2 = torch.where(sm != 0, (acmx / safe) * acmn - (b / safe) * b, -0.5 * rt)
    sgn1 = torch.where(sm < 0, -1, 1)
    cs = torch.where(df >= 0, df + rt, df - rt)
    sgn2 = torch.where(df >= 0, 1, -1)
    ct = -tb / torch.where(cs == 0, 1.0, cs)
    sn_a = 1.0 / _sqrt(1.0 + ct * ct)
    cs_a = ct * sn_a
    tn = -cs / torch.where(tb == 0, 1.0, tb)
    cs_b = 1.0 / _sqrt(1.0 + tn * tn)
    sn_b = tn * cs_b
    first = cs.abs() > ab
    cs1 = torch.where(first, cs_a, torch.where(ab == 0, torch.ones_like(a), cs_b))
    sn1 = torch.where(first, sn_a, torch.where(ab == 0, torch.zeros_like(a), sn_b))
    swap = sgn1 == sgn2
    return rt1, rt2, torch.where(swap, -sn1, cs1), torch.where(swap, cs1, sn1)


_EPS = 2.0 ** -24
_EPS2 = 2.0 ** -48
_SSFMAX = float(np.float32(2.0 ** 63) / np.float32(3.0))
_SSFMIN = 2.0 ** -15


def _ssteqr(d: torch.Tensor, e: torch.Tensor):
    """LAPACK's ssteqr with COMPZ = 'I' over a batch: d [B, n], e [B, n - 1]
    -> (eigenvalues ascending, Z [B, n, n], info). Every matrix takes its
    own next event of the routine (a split, a deflation or a 2x2 block, a
    QL or QR sweep, an unscaling) at each turn of the loop."""
    B, n = d.shape
    dev = d.device
    Z = torch.eye(n, dtype=_F32, device=dev).expand(B, n, n).clone()
    info = torch.zeros(B, dtype=torch.int64, device=dev)
    if n <= 1:
        return d.clone(), Z, info
    d = d.clone()
    e = torch.cat([e, torch.zeros((B, 1), dtype=_F32, device=dev)], 1)
    pos = torch.arange(1, n + 1, device=dev)[None]
    ones = torch.ones(B, dtype=torch.int64, device=dev)
    l1, l, lend, lsv, lendsv = ones.clone(), ones.clone(), ones.clone(), ones.clone(), ones.clone()
    jtot, iscale = torch.zeros_like(ones), torch.zeros_like(ones)
    phase = torch.zeros_like(ones)  # 0 split, 1 iterate, 2 unscale, 3 done, 4 failed
    isql = torch.zeros(B, dtype=torch.bool, device=dev)
    anorm = torch.zeros(B, dtype=_F32, device=dev)
    nmaxit = 30 * n

    def scale_block(mask, cfrom, cto):
        nonlocal d, e
        for mul, ap in _slascl_steps(cfrom, cto, mask):
            rd = ap[:, None] & (pos >= lsv_[:, None]) & (pos <= lendsv_[:, None])
            re = ap[:, None] & (pos >= lsv_[:, None]) & (pos <= lendsv_[:, None] - 1)
            d = torch.where(rd, d * mul[:, None], d)
            e = torch.where(re, e * mul[:, None], e)

    while bool(((phase == 0) | (phase == 1) | (phase == 2)).any()):
        # -- label 10: split off the next block
        sp = phase == 0
        if sp.any():
            fin = sp & (l1 > n)
            phase = torch.where(fin, 3, phase)
            sp = sp & ~fin
            e = _put(e, l1 - 1, 0.0, sp & (l1 > 1))
            tst = e[:, : n - 1].abs()
            thr = (_sqrt(d[:, : n - 1].abs()) * _sqrt(d[:, 1:].abs())) * _EPS
            cand = ((tst == 0) | (tst <= thr)) & (pos[:, : n - 1] >= l1[:, None])
            has = cand.any(1)
            m = torch.where(has, cand.int().argmax(1) + 1, n)
            e = _put(e, m, 0.0, sp & has)
            l = torch.where(sp, l1, l)
            lsv = torch.where(sp, l1, lsv)
            lend = torch.where(sp, m, lend)
            lendsv = torch.where(sp, m, lendsv)
            l1 = torch.where(sp, m + 1, l1)
            sp = sp & (lend != l)
            blk_d = (pos >= l[:, None]) & (pos <= lend[:, None])
            blk_e = (pos >= l[:, None]) & (pos <= lend[:, None] - 1)
            vals = torch.cat([torch.where(blk_d, d.abs(), 0.0), torch.where(blk_e, e.abs(), 0.0)], 1)
            an = torch.where(torch.isnan(vals).any(1), float("nan"), vals.max(1).values)
            anorm = torch.where(sp, an, anorm)
            sp = sp & (anorm != 0)
            big, small = sp & (anorm > _SSFMAX), sp & (anorm < _SSFMIN)
            iscale = torch.where(sp, torch.where(big, 1, torch.where(small, 2, 0)), iscale)
            lsv_, lendsv_ = lsv, lendsv
            scale_block(big, anorm, torch.full_like(anorm, _SSFMAX))
            scale_block(small, anorm, torch.full_like(anorm, _SSFMIN))
            swap = sp & (_gather(d, lend).abs() < _gather(d, l).abs())
            l, lend = torch.where(swap, lendsv, l), torch.where(swap, lsv, lend)
            isql = torch.where(sp, lend > l, isql)
            phase = torch.where(sp, 1, phase)
        it = phase == 1
        if it.any():
            d, e, Z, l, jtot, phase = _ssteqr_event(d, e, Z, it, isql, l, lend, jtot, phase, nmaxit, pos)
        un = phase == 2
        if un.any():
            lsv_, lendsv_ = lsv, lendsv
            scale_block(un & (iscale == 1), torch.full_like(anorm, _SSFMAX), anorm)
            scale_block(un & (iscale == 2), torch.full_like(anorm, _SSFMIN), anorm)
            fail = un & (jtot >= nmaxit)
            info = torch.where(fail, (e[:, : n - 1] != 0).sum(1), info)
            phase = torch.where(fail, 4, torch.where(un, 0, phase))
    # selection sort of the converged ones
    ok = phase == 3
    for i in range(n - 1):
        rest = d[:, i + 1 :]
        mn, k = rest.min(1)
        k = k + i + 1
        sw = ok & (mn < d[:, i])
        di = d[:, i].clone()
        d = torch.where(sw[:, None] & (pos - 1 == k[:, None]), di[:, None], d)
        d[:, i] = torch.where(sw, mn, d[:, i])
        zi = Z[:, :, i].clone()
        zk = Z.gather(2, k[:, None, None].expand(-1, n, 1))[:, :, 0]
        col = torch.arange(n, device=dev)[None, None]
        Z = torch.where(sw[:, None, None] & (col == k[:, None, None]), zi[:, :, None], Z)
        Z[:, :, i] = torch.where(sw[:, None], zk, Z[:, :, i])
    return d, Z, info


def _ssteqr_event(d, e, Z, it, isql, l, lend, jtot, phase, nmaxit, pos):
    """One event of ssteqr's labels 40 (QL) and 90 (QR) for the matrices in ``it``."""
    n = d.shape[1]
    ad, ae2 = d.abs(), e.abs() * e.abs()
    ql, qr = it & isql, it & ~isql
    # small subdiagonal: QL the first mm in [l, lend - 1], QR the last mm in [lend + 1, l]
    hit_ql = ae2[:, : n - 1] <= (_EPS2 * ad[:, : n - 1]) * ad[:, 1:] + _SAFMIN  # at mm = 1 .. n - 1 (e(mm))
    hit_qr = ae2[:, : n - 1] <= (_EPS2 * ad[:, 1:]) * ad[:, : n - 1] + _SAFMIN  # at mm = 2 .. n (e(mm - 1))
    p1 = pos[:, : n - 1]
    cql = hit_ql & (p1 >= l[:, None]) & (p1 <= lend[:, None] - 1)
    cqr = hit_qr & (p1 + 1 >= lend[:, None] + 1) & (p1 + 1 <= l[:, None])
    m_ql = torch.where(cql.any(1), cql.int().argmax(1) + 1, lend)
    last = (n - 2) - cqr.int().flip(1).argmax(1)
    m_qr = torch.where(cqr.any(1), last + 2, lend)
    m = torch.where(isql, m_ql, m_qr)
    e = _put(e, m, 0.0, ql & (m < lend))
    e = _put(e, m - 1, 0.0, qr & (m > lend))
    p = _gather(d, l)
    step = torch.where(isql, 1, -1)
    # an eigenvalue found
    a = it & (m == l)
    # a 2x2 block
    b = it & (m == l + step)
    lo = torch.where(isql, l, l - 1)
    rt1, rt2, c2, s2 = _slaev2(_gather(d, lo), _gather(e, lo), _gather(d, lo + 1))
    Z = _rotate(Z, lo, c2, s2, b)
    d = _put(_put(d, lo, rt1, b), lo + 1, rt2, b)
    e = _put(e, lo, 0.0, b)
    l = torch.where(a, l + step, torch.where(b, l + 2 * step, l))
    past = torch.where(isql, l > lend, l < lend)
    phase = torch.where((a | b) & past, 2, phase)
    # a sweep
    c = it & ~a & ~b
    stop = c & (jtot == nmaxit)
    phase = torch.where(stop, 2, phase)
    c = c & ~stop
    if c.any():
        jtot = jtot + c.long()
        el = _gather(e, lo)
        g = (_gather(d, l + step) - p) / (2.0 * el)
        r = _slapy2(g, torch.ones_like(g))
        g = (_gather(d, m) - p) + (el / (g + torch.copysign(r, g)))
        s = torch.ones_like(g)
        cc = torch.ones_like(g)
        pp = torch.zeros_like(g)
        span = int(torch.where(c, (m - l).abs(), 0).max())
        for t in range(span):
            i = torch.where(isql, m - 1 - t, m + t)
            act = c & torch.where(isql, i >= l, i <= l - 1)
            ei = _gather(e, i)
            f = s * ei
            bb = cc * ei
            cn, sn, rn = _slartg(g, f)
            e = _put(e, torch.where(isql, i + 1, i - 1), rn, act & (t > 0))
            dq = torch.where(isql, i + 1, i)  # the diagonal entry updated
            do = torch.where(isql, i, i + 1)  # the other one
            g = torch.where(act, _gather(d, dq) - pp, g)
            rr = (_gather(d, do) - g) * sn + (2.0 * cn) * bb
            pp = torch.where(act, sn * rr, pp)
            d = _put(d, dq, g + pp, act)
            g = torch.where(act, cn * rr - bb, g)
            cc = torch.where(act, cn, cc)
            s = torch.where(act, sn, s)
            Z = _rotate(Z, i, cn, torch.where(isql, -sn, sn), act)
        d = _put(d, l, _gather(d, l) - pp, c)
        e = _put(e, lo, g, c)
    return d, e, Z, l, jtot, phase


def syevd_ref(G: torch.Tensor):
    """Plain version: ``ssyevd('V', 'L')`` of symmetric f32 [B, n, n] (n <=
    25) -> (eigenvalues [B, n] ascending, eigenvectors [B, n, n] as
    columns, info [B])."""
    B, n = G.shape[0], G.shape[1]
    if n > NMAX:
        raise ValueError(f"syevd_ref reproduces ssyevd for n <= {NMAX}, got {n}")
    A = G.to(_F32).clone()
    if n == 1:
        return A[:, 0].clone(), torch.ones_like(A), torch.zeros(B, dtype=torch.int64, device=A.device)
    low = torch.tril(torch.ones((n, n), dtype=torch.bool, device=A.device))
    vals = torch.where(low, A.abs(), 0.0).flatten(1)
    anrm = torch.where(torch.isnan(torch.where(low, A, 0.0)).flatten(1).any(1), float("nan"), vals.max(1).values)
    rmin, rmax = _f32_sqrt(2.0 ** -103), _f32_sqrt(2.0 ** 103)
    lo_s = (anrm > 0) & (anrm < rmin)
    hi_s = anrm > rmax
    sigma = torch.where(lo_s, torch.full_like(anrm, rmin) / anrm,  # not rmin / anrm: torch's reciprocal times
                        torch.where(hi_s, torch.full_like(anrm, rmax) / anrm, torch.ones_like(anrm)))
    scaled = lo_s | hi_s
    for mul, ap in _slascl_steps(torch.ones_like(anrm), sigma, scaled):
        A = torch.where(ap[:, None, None] & low, A * mul[:, None, None], A)
    A, d, e, tau = _ssytd2(A)
    w, Z, info = _ssteqr(d, e)
    for i in range(n - 2, -1, -1):  # sormtr: sorm2r on Z[1:, :], H(n - 2) first
        v = torch.cat([torch.ones((B, 1), dtype=_F32, device=A.device), A[:, i + 2 :, i]], 1)
        Z[:, 1 + i :, :] = _slarf(v, tau[:, i], Z[:, 1 + i :, :])
    w = torch.where(scaled[:, None], w * (torch.ones_like(sigma) / sigma)[:, None], w)
    return w, Z, info


def _slarf(v: torch.Tensor, tau: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """LAPACK's slarf('L'): H C with H = I - tau v v^T, batched; the rows
    and columns it touches trimmed as slarf trims them (ILASLC)."""
    B, m, n = C.shape
    nz_v = v != 0
    lastv = torch.where(nz_v.any(1), m - nz_v.int().flip(1).argmax(1), 0)
    lastv = torch.where(tau != 0, lastv, 0)
    rowmask = torch.arange(m, device=C.device)[None] < lastv[:, None]
    colnz = ((C != 0) & rowmask[:, :, None]).any(1)  # [B, n]
    lastc = torch.where(colnz.any(1), n - colnz.int().flip(1).argmax(1), 0)
    out = C.clone()
    for key in torch.unique(lastv * (n + 1) + lastc).tolist():
        lv, lc = divmod(int(key), n + 1)
        if lv == 0 or lc == 0:
            continue
        sel = ((lastv == lv) & (lastc == lc)).nonzero()[:, 0]
        Cs, vs = C[sel, :lv, :lc], v[sel, :lv]
        w = _gemv_t(Cs, vs)
        t = -tau[sel][:, None] * w  # sger's alpha * y[j], rounded
        out[sel, :lv, :lc] = _fma(t[:, None, :], vs[:, :, None], Cs)
    return out


@lru_cache(maxsize=None)
def _program_table(device: str):
    """Every sgemv 'T' program packed for the kernel: ops (op << 6 | row)
    laid out by kind (4, 2, 1) then rows 0-25, and each one's start."""
    ops, offs = [], []
    for kind in ("4", "2", "1"):
        for rows in range(26):
            offs.append(len(ops))
            if rows:
                ops += [op << 6 | r for op, r in _program(kind, rows)]
    offs.append(len(ops))
    return (torch.tensor(ops, dtype=torch.int32, device=device),
            torch.tensor(offs, dtype=torch.int32, device=device))


def syevd(G: torch.Tensor, use_kernels: bool = True):
    """``ssyevd('V', 'L')`` of symmetric f32 [B, n, n] (n <= 25) ->
    (eigenvalues [B, n], eigenvectors [B, n, n], info [B] int32). CUDA
    tensors launch ``syevd_small`` (unless ``use_kernels=False``); CPU
    tensors take :func:`syevd_ref`; another device raises."""
    if G.device.type == "cpu" or not use_kernels:
        w, V, info = syevd_ref(G)
        return w, V, info.to(torch.int32)
    B, n = G.shape[0], G.shape[1]
    _native.require(G, "G", _F32, (B, n, n))
    if not 1 <= n <= NMAX:
        raise ValueError(f"syevd reproduces ssyevd for 1 <= n <= {NMAX}, got {n}")
    G = G.contiguous()
    ops, offs = _program_table(str(G.device))
    w = torch.empty((B, n), dtype=_F32, device=G.device)
    V = torch.empty((B, n, n), dtype=_F32, device=G.device)
    info = torch.empty(B, dtype=torch.int32, device=G.device)
    rc = _native.library().tt_syevd_small(G.data_ptr(), w.data_ptr(), V.data_ptr(), info.data_ptr(), ops.data_ptr(),
                                          offs.data_ptr(), B, n, _native.stream_ptr())
    _native.check(rc, "syevd_small")
    _native.count_launch("syevd_small")
    return w, V, info
