"""LAPACK's ``ssyevd`` for n <= 32 as jaxlib runs it on the test host, in its
own order of operations: the eigensolver of ``jnp.linalg.eigh`` (one
custom call, ``lapack_ssyevd_ffi``, into scipy's OpenBLAS 0.3.30 with its
SkylakeX kernels).

For n <= 32 ``ssyevd`` is: ``slansy``'s scaling test (and ``slascl`` of
the lower triangle where the norm is below sqrt(2^-103) or above its
inverse); ``ssytrd``, which up to 32 is ``ssytd2`` (``slarfg`` with
OpenBLAS's ``snrm2``, then ``ssymv``, ``sdot``, ``saxpy`` and ``ssyr2``);
``sstedc``, which for n <= 25 (SMLSIZ) is ``ssteqr`` (implicit QL / QR
with ``slaev2``, ``slartg``, ``slapy2``, ``slascl`` of each block outside
[2^-15, 2^63/3], at most 30 n sweeps, the final selection sort) and above
it divides and conquers (:func:`_sstedc`: the split where |e_f| <= eps
sqrt|d_f| sqrt|d_f+1|, a block above 25 rows scaled by ``slanst`` /
``slascl``, cut in two halves solved by ``ssteqr``, merged by ``slaed1``
-> ``slaed2``'s deflation (``slamrg``, Givens rotations by OpenBLAS's
``srot``: fma(c, x, s·y), fma(c, y, -(s·x))) -> ``slaed3`` (``slaed4``
with ``slaed5`` and ``slaed6`` for each root, the Gu-Eisenstat vector,
``snrm2``, then OpenBLAS's small ``sgemm``: one FMA chain a value over
at most 16 terms), scaled back, then the selection sort); ``sormtr`` =
``sorm2r`` (``slarf``: ``sgemv`` 'T' and ``sger``). From 33 rows
``ssytrd`` and from 34 ``sormqr`` turn blocked (not reproduced). The
Fortran is reference LAPACK built without FMA contraction (no fused
instruction in the routines' object code); OpenBLAS's kernels fuse where
they do. Found against ``scipy.linalg.blas`` and ``scipy.linalg.lapack``
and, for the divide and conquer, each routine alone through ctypes
(``scipy.libs/libscipy_openblas*.so``: ``scipy_slaed4_`` (with ``slaed5``
and ``slaed6`` inside) on random secular equations, ``scipy_sstedc_`` on
random tridiagonals, ``scipy_srot_`` and ``scipy_sgemm_``: ``python
tools/probe_orders.py slaed4 | sstedc N | blas``), then the whole
``ssyevd`` on seeded matrices, every bit of eigenvalues and eigenvectors:

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
- ``slaed4``'s divisions and square roots are IEEE's; its ``(x / y)**2``
  a product of the quotient by itself.
- ``sgemv`` 'T' (:func:`_gemv_t`, ``lda`` > rows as in ``slarf``):
  columns in groups of 4, then a pair, then one, each group's kernel adds
  a column's products in the tree :data:`_FORMS` gives for its row count,
  a product joining a sum either by an FMA ("F"), rounded then added
  ("M"), or (a pair, "R") the higher row's product rounded and the lower
  one fused onto it. Read off three-leaf probes (which pair is added
  first) and two-leaf probes (which rounding) of OpenBLAS's own ``sgemv``.

:func:`syevd_ref` is the plain version, vectorised over a batch of
matrices (the QL / QR sweeps run as a loop of events, every matrix taking
its own next step; the secular roots as lanes, each taking its own next
iteration; the deflation as a scan every matrix takes in step). On CUDA
tensors :func:`syevd` launches ``syevd_small`` (``csrc/pca.cu``): one
thread a matrix, the same arithmetic in LAPACK's scalar order.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tracking_tpu_torch.ops import _native, xla_math

_F32 = torch.float32
MAX_UNBLOCKED_N = 32  # the largest n whose ssytrd and sormtr run unblocked (33, 34 block): reproduced

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
    "4:26": "((((((0+8)+16)+((4+12)+20))+(((1+9)+17)+((5+13)+21)))+((((2+10)+18)+((6+14)+22))+(((3+11)+19)+((7+15)+23))))+(24+25)) --------FFFFFFFFFFFFFFFF-R",
    "4:27": "((((((0+8)+16)+((4+12)+20))+(((1+9)+17)+((5+13)+21)))+((((2+10)+18)+((6+14)+22))+(((3+11)+19)+((7+15)+23))))+((24+25)+26)) --------FFFFFFFFFFFFFFFF-RF",
    "4:28": "((((((0+4)+12)+20)+((8+16)+24))+((((1+5)+13)+21)+((9+17)+25)))+(((((2+6)+14)+22)+((10+18)+26))+((((3+7)+15)+23)+((11+19)+27)))) ----FFFF----FFFFFFFFFFFFFFFF",
    "4:29": "(((((((0+4)+12)+20)+((8+16)+24))+((((1+5)+13)+21)+((9+17)+25)))+(((((2+6)+14)+22)+((10+18)+26))+((((3+7)+15)+23)+((11+19)+27))))+28) ----FFFF----FFFFFFFFFFFFFFFFF",
    "4:30": "(((((((0+4)+12)+20)+((8+16)+24))+((((1+5)+13)+21)+((9+17)+25)))+(((((2+6)+14)+22)+((10+18)+26))+((((3+7)+15)+23)+((11+19)+27))))+(28+29)) ----FFFF----FFFFFFFFFFFFFFFF-R",
    "4:31": "(((((((0+4)+12)+20)+((8+16)+24))+((((1+5)+13)+21)+((9+17)+25)))+(((((2+6)+14)+22)+((10+18)+26))+((((3+7)+15)+23)+((11+19)+27))))+((28+29)+30)) ----FFFF----FFFFFFFFFFFFFFFF-RF",
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
    "2:26": "((((((((0+4)+8)+12)+16)+20)+(((((1+5)+9)+13)+17)+21))+((((((2+6)+10)+14)+18)+22)+(((((3+7)+11)+15)+19)+23)))+(24+25)) ----MMMMMMMMMMMMMMMMMMMM-R",
    "2:27": "((((((((0+4)+8)+12)+16)+20)+(((((1+5)+9)+13)+17)+21))+((((((2+6)+10)+14)+18)+22)+(((((3+7)+11)+15)+19)+23)))+((24+25)+26)) ----MMMMMMMMMMMMMMMMMMMM-RF",
    "2:28": "((((((((0+4)+8)+12)+16)+20)+24)+((((((1+5)+9)+13)+17)+21)+25))+(((((((2+6)+10)+14)+18)+22)+26)+((((((3+7)+11)+15)+19)+23)+27))) ----MMMMMMMMMMMMMMMMMMMMMMMM",
    "2:29": "(((((((((0+4)+8)+12)+16)+20)+24)+((((((1+5)+9)+13)+17)+21)+25))+(((((((2+6)+10)+14)+18)+22)+26)+((((((3+7)+11)+15)+19)+23)+27)))+28) ----MMMMMMMMMMMMMMMMMMMMMMMMF",
    "2:30": "(((((((((0+4)+8)+12)+16)+20)+24)+((((((1+5)+9)+13)+17)+21)+25))+(((((((2+6)+10)+14)+18)+22)+26)+((((((3+7)+11)+15)+19)+23)+27)))+(28+29)) ----MMMMMMMMMMMMMMMMMMMMMMMM-R",
    "2:31": "(((((((((0+4)+8)+12)+16)+20)+24)+((((((1+5)+9)+13)+17)+21)+25))+(((((((2+6)+10)+14)+18)+22)+26)+((((((3+7)+11)+15)+19)+23)+27)))+((28+29)+30)) ----MMMMMMMMMMMMMMMMMMMMMMMM-RF",
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
    "1:26": "((((((0+8)+16)+((4+12)+20))+(((1+9)+17)+((5+13)+21)))+((((2+10)+18)+((6+14)+22))+(((3+11)+19)+((7+15)+23))))+(24+25)) --------MMMMMMMMMMMMMMMM-R",
    "1:27": "((((((0+8)+16)+((4+12)+20))+(((1+9)+17)+((5+13)+21)))+((((2+10)+18)+((6+14)+22))+(((3+11)+19)+((7+15)+23))))+((24+25)+26)) --------MMMMMMMMMMMMMMMM-RF",
    "1:28": "((((((0+4)+12)+20)+((8+16)+24))+((((1+5)+13)+21)+((9+17)+25)))+(((((2+6)+14)+22)+((10+18)+26))+((((3+7)+15)+23)+((11+19)+27)))) ----MMMM----MMMMMMMMMMMMMMMM",
    "1:29": "(((((((0+4)+12)+20)+((8+16)+24))+((((1+5)+13)+21)+((9+17)+25)))+(((((2+6)+14)+22)+((10+18)+26))+((((3+7)+15)+23)+((11+19)+27))))+28) ----MMMM----MMMMMMMMMMMMMMMMF",
    "1:30": "(((((((0+4)+12)+20)+((8+16)+24))+((((1+5)+13)+21)+((9+17)+25)))+(((((2+6)+14)+22)+((10+18)+26))+((((3+7)+15)+23)+((11+19)+27))))+(28+29)) ----MMMM----MMMMMMMMMMMMMMMM-R",
    "1:31": "(((((((0+4)+12)+20)+((8+16)+24))+((((1+5)+13)+21)+((9+17)+25)))+(((((2+6)+14)+22)+((10+18)+26))+((((3+7)+15)+23)+((11+19)+27))))+((28+29)+30)) ----MMMM----MMMMMMMMMMMMMMMM-RF",
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
    return _at(x, idx - 1)


def _put(x: torch.Tensor, idx: torch.Tensor, val, mask: torch.Tensor) -> torch.Tensor:
    """x with x[b, idx[b] - 1] = val[b] where mask."""
    return _set(x, idx - 1, val, mask)


def _at(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """x[b, j[b]] (0-based j, clamped)."""
    return x.gather(1, j.clamp(0, x.shape[1] - 1)[:, None])[:, 0]


def _set(x: torch.Tensor, j: torch.Tensor, v, mask: torch.Tensor) -> torch.Tensor:
    """x with x[b, j[b]] = v[b] (0-based j) where mask."""
    pos = torch.arange(x.shape[1], device=x.device)[None]
    if not isinstance(v, torch.Tensor):
        v = torch.full(x.shape[:1], v, dtype=x.dtype, device=x.device)
    return torch.where(mask[:, None] & (pos == j[:, None]), v[:, None], x)


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
    d, Z = _selection_sort(d, Z, phase == 3)  # the converged ones
    return d, Z, info


def _selection_sort(d: torch.Tensor, Z: torch.Tensor, ok: torch.Tensor):
    """LAPACK's selection sort (ssteqr's and sstedc's last step) of d [B, n]
    and the columns of Z [B, m, n] where ``ok``: the first minimum of the
    rest swapped in."""
    n = d.shape[1]
    pos = torch.arange(n, device=d.device)[None]
    col = pos[:, None]
    d, Z = d.clone(), Z.clone()
    for i in range(n - 1):
        mn, k = d[:, i + 1 :].min(1)
        k = k + i + 1
        sw = ok & (mn < d[:, i])
        di = d[:, i].clone()
        d = torch.where(sw[:, None] & (pos == k[:, None]), di[:, None], d)
        d[:, i] = torch.where(sw, mn, d[:, i])
        zi = Z[:, :, i].clone()
        zk = Z.gather(2, k[:, None, None].expand(-1, Z.shape[1], 1))[:, :, 0]
        Z = torch.where(sw[:, None, None] & (col == k[:, None, None]), zi[:, :, None], Z)
        Z[:, :, i] = torch.where(sw[:, None], zk, Z[:, :, i])
    return d, Z


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


SMLSIZ = 25  # LAPACK's SMLSIZ (ilaenv 9): above it sstedc divides and conquers


def _col(M: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """M[b, :, j[b]] (0-based j)."""
    return M.gather(2, j.clamp(0, M.shape[2] - 1)[:, None, None].expand(-1, M.shape[1], 1))[:, :, 0]


def _set_col(M: torch.Tensor, j: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    col = torch.arange(M.shape[2], device=M.device)[None, None]
    return torch.where(mask[:, None, None] & (col == j[:, None, None]), v[:, :, None], M)


def _slamrg(a: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor, s2: int) -> torch.Tensor:
    """LAPACK's slamrg(N1, N2, A, 1, S2): the 0-based permutation merging
    a[:, :n1] ascending with a[:, n1:n1 + n2] read forwards (s2 = 1) or
    backwards (s2 = -1); ties take the first run."""
    B, n = a.shape
    i1 = torch.zeros_like(n1)
    i2 = torch.where(torch.full_like(n1, s2) > 0, n1, n1 + n2 - 1)
    r1, r2 = n1.clone(), n2.clone()
    out = torch.zeros((B, n), dtype=torch.int64, device=a.device)
    for i in range(n):
        live = i < n1 + n2
        first = (r1 > 0) & ((r2 == 0) | (_at(a, i1) <= _at(a, i2)))
        out[:, i] = torch.where(first, i1, i2)
        i1 = torch.where(live & first, i1 + 1, i1)
        i2 = torch.where(live & ~first, i2 + s2, i2)
        r1 = torch.where(live & first, r1 - 1, r1)
        r2 = torch.where(live & ~first, r2 - 1, r2)
    return out


_EIGHT, _TEN = 8.0, 10.0


def _slaed5(i2, d, z, rho):
    """LAPACK's slaed5 over lanes: d, z [L, 2]; i2 [L] true for I = 2 ->
    (delta [L, 2], dlam [L])."""
    d1, d2, z1, z2 = d[:, 0], d[:, 1], z[:, 0], z[:, 1]
    dl = d2 - d1
    w = 1.0 + 2.0 * rho * (z2 * z2 - z1 * z1) / dl
    up = ~i2 & (w > 0)
    b_up = dl + rho * (z1 * z1 + z2 * z2)
    c_up = rho * z1 * z1 * dl
    tau_up = 2.0 * c_up / (b_up + _sqrt((b_up * b_up - 4.0 * c_up).abs()))
    b = -dl + rho * (z1 * z1 + z2 * z2)
    c = rho * z2 * z2 * dl
    root = _sqrt(b * b + 4.0 * c)
    tau_dn = torch.where(b > 0, -(2.0 * c / (b + root)), (b - root) / 2.0)
    tau_2 = torch.where(b > 0, (b + root) / 2.0, 2.0 * c / (-b + root))
    tau = torch.where(up, tau_up, torch.where(i2, tau_2, tau_dn))
    dlam = torch.where(up, d1 + tau, d2 + tau)
    e1 = torch.where(up, -z1 / tau, -z1 / (dl + tau))
    e2 = torch.where(up, z2 / (dl - tau), -z2 / tau)
    temp = _sqrt(e1 * e1 + e2 * e2)
    return torch.stack([e1 / temp, e2 / temp], 1), dlam


_SMALL1 = 2.0 ** -42  # slaed6's BASE ** INT(LOG(SAFMIN) / LOG(BASE) / 3)


def _slaed6(kniter2, orgati, rho, d, z, finit, live):
    """LAPACK's slaed6 over lanes (``live`` ones): d, z [L, 3] -> (tau, info)."""
    lbd = torch.where(orgati, d[:, 1], d[:, 0])
    ubd = torch.where(orgati, d[:, 2], d[:, 1])
    neg = finit < 0
    lbd = torch.where(neg, torch.zeros_like(lbd), lbd)
    ubd = torch.where(neg, ubd, torch.zeros_like(ubd))
    tau = torch.zeros_like(rho)
    # KNITER = 2: a first guess from the quadratic through two poles
    t_o = (d[:, 2] - d[:, 1]) / 2.0
    c_o = rho + z[:, 0] / ((d[:, 0] - d[:, 1]) - t_o)
    a_o = c_o * (d[:, 1] + d[:, 2]) + z[:, 1] + z[:, 2]
    b_o = c_o * d[:, 1] * d[:, 2] + z[:, 1] * d[:, 2] + z[:, 2] * d[:, 1]
    t_n = (d[:, 0] - d[:, 1]) / 2.0
    c_n = rho + z[:, 2] / ((d[:, 2] - d[:, 1]) - t_n)
    a_n = c_n * (d[:, 0] + d[:, 1]) + z[:, 0] + z[:, 1]
    b_n = c_n * d[:, 0] * d[:, 1] + z[:, 0] * d[:, 1] + z[:, 1] * d[:, 0]
    a, b, c = torch.where(orgati, a_o, a_n), torch.where(orgati, b_o, b_n), torch.where(orgati, c_o, c_n)
    temp = torch.maximum(torch.maximum(a.abs(), b.abs()), c.abs())
    a, b, c = a / temp, b / temp, c / temp
    g = _quad(a, b, c, b / a)
    g = torch.where((g < lbd) | (g > ubd), (lbd + ubd) / 2.0, g)
    hit = (d[:, 0] == g) | (d[:, 1] == g) | (d[:, 2] == g)
    f2 = (finit + g * z[:, 0] / (d[:, 0] * (d[:, 0] - g)) + g * z[:, 1] / (d[:, 1] * (d[:, 1] - g))
          + g * z[:, 2] / (d[:, 2] * (d[:, 2] - g)))
    k2 = kniter2 & ~hit
    lbd = torch.where(k2 & (f2 <= 0), g, lbd)
    ubd = torch.where(k2 & (f2 > 0), g, ubd)
    tau = torch.where(k2 & ~(finit.abs() <= f2.abs()), g, tau)
    # scaling where the root is within SMALL1 of a pole
    small2 = _SMALL1 * _SMALL1
    temp = torch.where(orgati, torch.minimum((d[:, 1] - tau).abs(), (d[:, 2] - tau).abs()),
              torch.minimum((d[:, 0] - tau).abs(), (d[:, 1] - tau).abs()))
    scale = temp <= _SMALL1
    sclfac = torch.where(temp <= small2, torch.full_like(tau, 1.0 / small2), torch.full_like(tau, 1.0 / _SMALL1))
    sclinv = torch.where(temp <= small2, torch.full_like(tau, small2), torch.full_like(tau, _SMALL1))
    ds = torch.where(scale[:, None], d * sclfac[:, None], d)
    zs = torch.where(scale[:, None], z * sclfac[:, None], z)
    tau = torch.where(scale, tau * sclfac, tau)
    lbd = torch.where(scale, lbd * sclfac, lbd)
    ubd = torch.where(scale, ubd * sclfac, ubd)
    fc, df, ddf = torch.zeros_like(tau), torch.zeros_like(tau), torch.zeros_like(tau)
    for q in range(3):
        t = 1.0 / (ds[:, q] - tau)
        t1 = zs[:, q] * t
        t2 = t1 * t
        fc = fc + t1 / ds[:, q]
        df = df + t2
        ddf = ddf + t2 * t
    f = finit + tau * fc
    go = live & ~(f.abs() <= 0)
    lbd = torch.where(go & (f <= 0), tau, lbd)
    ubd = torch.where(go & (f > 0), tau, ubd)
    info = torch.zeros(tau.shape, dtype=torch.int64, device=tau.device)
    for _ in range(2, 41):
        if not bool(go.any()):
            break
        t1 = torch.where(orgati, ds[:, 1] - tau, ds[:, 0] - tau)
        t2 = torch.where(orgati, ds[:, 2] - tau, ds[:, 1] - tau)
        a = (t1 + t2) * f - t1 * t2 * df
        b = t1 * t2 * f
        c = f - (t1 + t2) * df + t1 * t2 * ddf
        temp = torch.maximum(torch.maximum(a.abs(), b.abs()), c.abs())
        a, b, c = a / temp, b / temp, c / temp
        eta = _quad(a, b, c, b / a)
        eta = torch.where(f * eta >= 0, -f / df, eta)
        nt = tau + eta
        nt = torch.where((nt < lbd) | (nt > ubd), (lbd + ubd) / 2.0, nt)
        tau = torch.where(go, nt, tau)
        fc, erretm, df2, ddf2 = (torch.zeros_like(tau) for _ in range(4))
        pole = torch.zeros_like(go)
        for q in range(3):
            dq = ds[:, q] - tau
            pole = pole | (dq == 0)
            t = 1.0 / dq
            t1 = zs[:, q] * t
            t2 = t1 * t
            t4 = t1 / ds[:, q]
            fc = fc + t4
            erretm = erretm + t4.abs()
            df2 = df2 + t2
            ddf2 = ddf2 + t2 * t
        go = go & ~pole
        df, ddf = torch.where(go, df2, df), torch.where(go, ddf2, ddf)
        f = torch.where(go, finit + tau * fc, f)
        erretm = _EIGHT * (finit.abs() + tau.abs() * erretm) + tau.abs() * df
        done = (f.abs() <= (4.0 * _EPS) * erretm) | ((ubd - lbd) <= (4.0 * _EPS) * tau.abs())
        go = go & ~done
        lbd = torch.where(go & (f <= 0), tau, lbd)
        ubd = torch.where(go & (f > 0), tau, ubd)
    info = torch.where(go, torch.ones_like(info), info)
    return torch.where(scale, tau * sclinv, tau), info


def _quad(a, b, c, at_c0):
    """LAPACK's root of the interpolating quadratic: ``at_c0`` where c = 0,
    (a - sqrt|a² - 4bc|) / 2c where a <= 0, else 2b / (a + sqrt|a² - 4bc|)."""
    root = _sqrt((a * a - 4.0 * b * c).abs())
    return torch.where(c == 0, at_c0, torch.where(a <= 0, (a - root) / (2.0 * c), 2.0 * b / (a + root)))


def _sums(z, delta, lo, hi, err=None, rev: bool = False):
    """slaed4's sum over j in [lo, hi) (``rev``: from hi - 1 down) of
    z_j * (z_j / delta_j) and of (z_j / delta_j)², with its running total of
    the partial sums added to ``err`` -> (sum, dsum, err)."""
    L, N = z.shape
    s, ds = (torch.zeros(L, dtype=_F32, device=z.device) for _ in range(2))
    err = torch.zeros_like(s) if err is None else err
    for j in (range(N - 1, -1, -1) if rev else range(N)):
        on = (j >= lo) & (j < hi)
        t = z[:, j] / delta[:, j]
        ns = s + z[:, j] * t
        s = torch.where(on, ns, s)
        ds = torch.where(on, ds + t * t, ds)
        err = torch.where(on, err + ns, err)
    return s, ds, err


def _sq_sum(z, delta, lo, hi, rev: bool = False):
    """The initial guess's sum of z_j * z_j / delta_j over j in [lo, hi)."""
    s = torch.zeros(z.shape[0], dtype=_F32, device=z.device)
    for j in (range(z.shape[1] - 1, -1, -1) if rev else range(z.shape[1])):
        s = torch.where((j >= lo) & (j < hi), s + z[:, j] * z[:, j] / delta[:, j], s)
    return s


_MAXIT = 30


def _slaed4(n, i, D, Z, rho):
    """LAPACK's slaed4 (n >= 3) over lanes: the i-th root (0-based, [L]) of
    the secular equation of D, Z [L, N] (the first n [L] used) -> (delta
    [L, N], dlam [L], info [L])."""
    L, N = D.shape
    info = torch.zeros(L, dtype=torch.int64, device=D.device)
    rhoinv = 1.0 / rho
    zero = torch.zeros_like(rho)
    last = i == n - 1
    ip1 = (i + 1).clamp(max=N - 1)
    Di, Dip1, Zi, Zip1 = _at(D, i), _at(D, ip1), _at(Z, i), _at(Z, ip1)
    Dn, Dn1, Zn, Zn1 = _at(D, n - 1), _at(D, n - 2), _at(Z, n - 1), _at(Z, n - 2)
    # initial guess, I = N
    midpt = rho / 2.0
    delta = (D - Di[:, None]) - midpt[:, None]
    c = rhoinv + _sq_sum(Z, delta, 0, n - 2)
    w = c + Zn1 * Zn1 / _at(delta, n - 2) + Zn * Zn / _at(delta, n - 1)
    temp = Zn1 * Zn1 / (Dn - Dn1 + rho) + Zn * Zn / rho
    dl = Dn - Dn1
    a = -c * dl + Zn1 * Zn1 + Zn * Zn
    b = Zn * Zn * dl
    root = _sqrt(a * a + 4.0 * b * c)
    tq = torch.where(a < 0, 2.0 * b / (root - a), (a + root) / (2.0 * c))
    wle = w <= 0
    tau_n = torch.where(wle & (c <= temp), rho, tq)
    lb_n, ub_n = torch.where(wle, midpt, zero), torch.where(wle, rho, midpt)
    # initial guess, I < N
    dl = Dip1 - Di
    mid = dl / 2.0
    delta = (D - Di[:, None]) - mid[:, None]
    c = rhoinv + _sq_sum(Z, delta, 0, i) + _sq_sum(Z, delta, i + 2, n, rev=True)
    w = c + Zi * Zi / _at(delta, i) + Zip1 * Zip1 / _at(delta, ip1)
    orgati = last | (w > 0)
    a = c * dl + Zi * Zi + Zip1 * Zip1
    b = Zi * Zi * dl
    root = _sqrt((a * a - 4.0 * b * c).abs())
    t_o = torch.where(a > 0, 2.0 * b / (a + root), (a - root) / (2.0 * c))
    a = c * dl - Zi * Zi - Zip1 * Zip1
    b = Zip1 * Zip1 * dl
    root = _sqrt((a * a + 4.0 * b * c).abs())
    t_n = torch.where(a < 0, 2.0 * b / (a - root), -(a + root) / (2.0 * c))
    tau = torch.where(last, tau_n, torch.where(orgati, t_o, t_n))
    dltlb = torch.where(last, lb_n, torch.where(orgati, zero, -mid))
    dltub = torch.where(last, ub_n, torch.where(orgati, mid, zero))
    origin = torch.where(orgati, Di, Dip1)
    delta = (D - origin[:, None]) - tau[:, None]
    ii = torch.where(last, n - 2, torch.where(orgati, i, ip1))  # 0-based II
    iim1, iip1 = (ii - 1).clamp(min=0), (ii + 1).clamp(max=N - 1)
    Zii, Ziim1, Ziip1 = _at(Z, ii), _at(Z, iim1), _at(Z, iip1)
    Diim1, Diip1 = _at(D, iim1), _at(D, iip1)

    def evaluate(delta, tau):
        psi, dpsi, e = _sums(Z, delta, 0, torch.where(last, n - 1, ii))
        e = e.abs()
        phi, dphi, err = _sums(Z, delta, torch.where(last, n - 1, ii + 1), n, e, rev=True)
        # I = N
        w_n = rhoinv + phi + psi
        err_n = _EIGHT * (-phi - psi) + e - phi + rhoinv + tau.abs() * (dpsi + dphi)
        # I < N
        t = Zii / _at(delta, ii)
        dw = dpsi + dphi + t * t
        t = Zii * t
        w_i = rhoinv + phi + psi + t
        err_i = _EIGHT * (phi - psi) + err + 2.0 * rhoinv + 3.0 * t.abs() + tau.abs() * dw
        w, err = torch.where(last, w_n, w_i), torch.where(last, err_n, err_i)
        return psi, dpsi, phi, dphi, w, err, dw, rhoinv + phi + psi

    psi, dpsi, phi, dphi, w, err, dw, w0 = evaluate(delta, tau)
    swtch3 = ~last & torch.where(orgati, w0 < 0, w0 > 0) & (ii != 0) & (ii != n - 1)
    swtch = torch.zeros_like(last)
    act = ~(w.abs() <= _EPS * err)
    for step in range(1, _MAXIT):
        if not bool(act.any()):
            break
        first = step == 1
        dltlb = torch.where(act & (w <= 0), torch.maximum(dltlb, tau), dltlb)
        dltub = torch.where(act & (w > 0), torch.minimum(dltub, tau), dltub)
        dlo, dhi = _at(delta, i), _at(delta, ip1)
        # I = N
        dn1, dn = _at(delta, n - 2), _at(delta, n - 1)
        c = w - dn1 * dpsi - dn * dphi
        a = (dn1 + dn) * w - dn1 * dn * (dpsi + dphi)
        b = dn1 * dn * w
        c = c.abs() if first else c
        root = _sqrt((a * a - 4.0 * b * c).abs())
        eta_n = torch.where(a >= 0, (a + root) / (2.0 * c), 2.0 * b / (a - root))
        if first:
            eta_n = torch.where(c == 0, -w / (dpsi + dphi), eta_n)
        eta_n = torch.where(w * eta_n > 0, -w / (dpsi + dphi), eta_n)
        # I < N, two poles
        tz = Zii / _at(delta, ii)
        dpsi_s = torch.where(swtch & orgati, dpsi + tz * tz, dpsi)
        dphi_s = torch.where(swtch & ~orgati, dphi + tz * tz, dphi)
        c_o = w - dhi * dw - (Di - Dip1) * _sqr(Zi / dlo)
        c_n = w - dlo * dw - (Dip1 - Di) * _sqr(Zip1 / dhi)
        c = torch.where(swtch, w - dlo * dpsi_s - dhi * dphi_s, torch.where(orgati, c_o, c_n))
        a = (dlo + dhi) * w - dlo * dhi * dw
        b = dlo * dhi * w
        a0 = torch.where(swtch, dlo * dlo * dpsi_s + dhi * dhi * dphi_s,
                torch.where(orgati, Zi * Zi + dhi * dhi * (dpsi + dphi), Zip1 * Zip1 + dlo * dlo * (dpsi + dphi)))
        eta_2 = _quad(a, b, c, b / torch.where(a == 0, a0, a))
        # I < N, three poles (slaed6)
        t3 = rhoinv + psi + phi
        dm, dp = _at(delta, iim1), _at(delta, iip1)
        t1o = _sqr(Ziim1 / dm)
        t1n = _sqr(Ziip1 / dp)
        c_sw = t3 - dm * dpsi - dp * dphi
        c3 = torch.where(swtch, c_sw, torch.where(orgati, t3 - dp * (dpsi + dphi) - (Diim1 - Diip1) * t1o,
                                  t3 - dm * (dpsi + dphi) - (Diip1 - Diim1) * t1n))
        zz1 = torch.where(swtch, dm * dm * dpsi, torch.where(orgati, Ziim1 * Ziim1, dm * dm * (dpsi + (dphi - t1n))))
        zz3 = torch.where(swtch, dp * dp * dphi, torch.where(orgati, dp * dp * ((dpsi - t1o) + dphi), Ziip1 * Ziip1))
        three = act & swtch3
        if bool(three.any()):
            eta_3, inf6 = _slaed6(torch.full_like(three, first), orgati, c3, torch.stack([dm, _at(delta, ii), dp], 1),
                                  torch.stack([zz1, Zii * Zii, zz3], 1), w, three)
        else:
            eta_3, inf6 = zero, torch.zeros_like(info)
        fail = three & (inf6 != 0)
        info = torch.where(fail, inf6, info)
        act = act & ~fail
        eta = torch.where(last, eta_n, torch.where(swtch3, eta_3, eta_2))
        eta = torch.where(~last & (w * eta >= 0), -w / dw, eta)
        nt = tau + eta
        half = torch.where(w < 0, (dltub - tau) / 2.0, (dltlb - tau) / 2.0)
        eta = torch.where((nt > dltub) | (nt < dltlb), half, eta)
        delta = torch.where(act[:, None], delta - eta[:, None], delta)
        tau = torch.where(act, tau + eta, tau)
        prew = w
        old = (psi, dpsi, phi, dphi, w, err, dw)
        psi, dpsi, phi, dphi, w, err, dw = (torch.where(act, a, b) for a, b in zip(evaluate(delta, tau), old))
        tenth = prew.abs() / torch.full_like(prew, _TEN)
        if first:
            flip = torch.where(orgati, -w > tenth, w > tenth)
            swtch = act & flip
        else:
            swtch = torch.where(act & (w * prew > 0) & (w.abs() > tenth), ~swtch, swtch)
        if step < _MAXIT - 1:
            act = act & ~(w.abs() <= _EPS * err)
    info = torch.where(act, torch.ones_like(info), info)
    return delta, origin + tau, info


def _sqr(x):
    return x * x  # Fortran's x**2


_RSQRT2 = float(np.float32(1.0) / np.sqrt(np.float32(2.0)))  # slaed2's ONE / SQRT(TWO)


def _srot(x, y, c, s):
    """OpenBLAS's srot kernel: (fma(c, x, s·y), fma(c, y, -(s·x)))."""
    return _fma(c, x, s * y), _fma(c, y, -(s * x))


def _slaed2(d, Q, indxq, rho, z, n1: int):
    """LAPACK's slaed2 over a batch (every matrix of size n, cut at n1):
    deflation. Returns the secular problem (k, dlamda, w [B, n]), the
    grouped columns (indx, indxc [B, n] 0-based, ctot [B, 4]), and d, Q with
    the deflated eigenpairs in positions k.. (Q's first k columns are the
    ones slaed3 overwrites)."""
    B, n = d.shape
    dev = d.device
    pos = torch.arange(n, device=dev)[None]
    bsel = torch.arange(B, device=dev)
    z = torch.where((rho < 0)[:, None] & (pos >= n1), -z, z)
    z = z * _RSQRT2
    rho = (2.0 * rho).abs()
    indxq = torch.where(pos >= n1, indxq + n1, indxq)
    dlamda = d.gather(1, indxq)
    indxc = _slamrg(dlamda, torch.full((B,), n1, device=dev), torch.full((B,), n - n1, device=dev), 1)
    indx = indxq.gather(1, indxc)
    zmax = _at(z.abs(), z.abs().argmax(1))
    dmax = _at(d.abs(), d.abs().argmax(1))
    tol = (_EIGHT * _EPS) * torch.maximum(dmax, zmax)
    none = rho * zmax <= tol  # the rank-one modifier is negligible: k = 0
    live = ~none
    coltyp = torch.where(pos < n1, 1, 3).expand(B, n).clone()
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    k2 = torch.full((B,), n, dtype=torch.int64, device=dev)  # Fortran's K2 - 1
    indxp = torch.zeros((B, n), dtype=torch.int64, device=dev)
    dl_out, w_out = torch.zeros_like(d), torch.zeros_like(d)
    started = torch.zeros(B, dtype=torch.bool, device=dev)
    pj = torch.zeros(B, dtype=torch.int64, device=dev)
    d, Q = d.clone(), Q.clone()
    for J in range(n):
        nj = indx[:, J]
        defl = rho * _at(z, nj).abs() <= tol
        a = live & defl
        k2 = torch.where(a, k2 - 1, k2)
        coltyp = _set(coltyp, nj, 4, a)
        indxp = _set(indxp, k2, nj, a)
        first = live & ~defl & ~started
        cont = live & ~defl & started
        pj = torch.where(first, nj, pj)
        started = started | first
        # two nearly equal eigenvalues: a Givens rotation zeroes z(pj)
        s, c = _at(z, pj), _at(z, nj)
        tau = _slapy2(c, s)
        t = _at(d, nj) - _at(d, pj)
        c = c / tau
        s = -s / tau
        rot = cont & ((t * c * s).abs() <= tol)
        z = _set(_set(z, nj, tau, rot), pj, 0.0, rot)
        ct_nj, ct_pj = _at(coltyp, nj), _at(coltyp, pj)
        coltyp = _set(coltyp, nj, 2, rot & (ct_nj != ct_pj))
        coltyp = _set(coltyp, pj, 4, rot)
        xq, yq = _srot(_col(Q, pj), _col(Q, nj), c[:, None], s[:, None])
        Q = _set_col(_set_col(Q, pj, xq, rot), nj, yq, rot)
        dp, dn = _at(d, pj), _at(d, nj)
        tp = dp * (c * c) + dn * (s * s)
        d = _set(_set(d, nj, dp * (s * s) + dn * (c * c), rot), pj, tp, rot)
        k2 = torch.where(rot, k2 - 1, k2)
        # insert pj into the deflated list, kept in decreasing order
        mv = rot.clone()
        at = k2.clone()
        for q in range(1, n):
            nxt = at + 1
            step = mv & (nxt < n) & (tp < _at(d, _at(indxp, nxt)))
            indxp = _set(indxp, at, _at(indxp, nxt), step)
            at = torch.where(step, nxt, at)
            mv = step
        indxp = _set(indxp, at, pj, rot)
        keep = cont & ~rot
        dl_out = _set(dl_out, k, _at(d, pj), keep)
        w_out = _set(w_out, k, _at(z, pj), keep)
        indxp = _set(indxp, k, pj, keep)
        k = torch.where(keep, k + 1, k)
        pj = torch.where(rot | keep, nj, pj)
    dl_out = _set(dl_out, k, _at(d, pj), live)
    w_out = _set(w_out, k, _at(z, pj), live)
    indxp = _set(indxp, k, pj, live)
    k = torch.where(live, k + 1, k)
    # group the columns by type: 1 (top only), 2 (both), 3 (bottom only), 4 (deflated)
    ctot = torch.stack([(coltyp == t).sum(1) for t in (1, 2, 3, 4)], 1)
    psm = torch.cat([torch.zeros_like(ctot[:, :1]), ctot.cumsum(1)[:, :3]], 1)
    g_indx, g_indxc = torch.zeros_like(indx), torch.zeros_like(indx)
    for J in range(n):
        js = indxp[:, J]
        ct = _at(coltyp, js) - 1
        p = psm.gather(1, ct[:, None])[:, 0]
        g_indx = _set(g_indx, p, js, live)
        g_indxc = _set(g_indxc, p, torch.full_like(js, J), live)
        psm = psm.scatter_add(1, ct[:, None], torch.ones_like(ct)[:, None])
    # none deflated in full: the columns sorted by d, k = 0
    g_indx = torch.where(none[:, None], indx, g_indx)
    k = torch.where(none, 0, k)
    dz = d.gather(1, g_indx)
    Qg = Q.gather(2, g_indx[:, None, :].expand(-1, n, -1))
    d = torch.where(pos >= k[:, None], dz, d)
    Q = torch.where((pos >= k[:, None])[:, None, :], Qg, Q)
    return k, dl_out, w_out, rho, g_indx, g_indxc, ctot, d, Q, Qg


def _slaed3(k, dlamda, w, rho, indxc, ctot, Qg, n1: int):
    """LAPACK's slaed3 over a batch: the roots of the secular equations
    (slaed4 for each, slaed5 where k = 2), the Gu-Eisenstat vectors, and
    the eigenvectors back in the merged basis (sgemm: one FMA chain a
    value). Returns (eigenvalues [B, n] in the first k, vectors [B, n, n]
    in the first k columns)."""
    B, n = dlamda.shape
    dev = dlamda.device
    pos = torch.arange(n, device=dev)[None]
    bb, jj = torch.nonzero(pos < k[:, None], as_tuple=True)  # a lane a root
    kk = k[bb]
    Dl, Wl, rl = dlamda[bb], w[bb], rho[bb]
    lam = torch.zeros((B, n), dtype=_F32, device=dev)
    S = torch.zeros((B, n, n), dtype=_F32, device=dev)  # S[b, :, j]: slaed4's delta for root j
    if bb.numel():
        delta = torch.zeros((bb.numel(), n), dtype=_F32, device=dev)
        dl = torch.zeros(bb.numel(), dtype=_F32, device=dev)
        info = torch.zeros(bb.numel(), dtype=torch.int64, device=dev)
        one = kk == 1
        delta[:, 0] = torch.where(one, 1.0, delta[:, 0])
        dl = torch.where(one, Dl[:, 0] + rl * Wl[:, 0] * Wl[:, 0], dl)
        two = kk == 2
        if bool(two.any()):
            d5, l5 = _slaed5(jj == 1, Dl[:, :2], Wl[:, :2], rl)
            delta[:, :2] = torch.where(two[:, None], d5, delta[:, :2])
            dl = torch.where(two, l5, dl)
        big = kk >= 3
        if bool(big.any()):
            sel = big.nonzero()[:, 0]
            pad = torch.where(pos < kk[sel, None], Dl[sel], Dl[sel].max(1, keepdim=True).values + 1.0 + pos)
            d4, l4, i4 = _slaed4(kk[sel], jj[sel], pad, torch.where(pos < kk[sel, None], Wl[sel], 0.0), rl[sel])
            delta[sel] = d4
            dl[sel] = l4
            info[sel] = i4
        lam[bb, jj] = dl
        S[bb, :, jj] = torch.where(pos < kk[:, None], delta, 0.0)
    gram = k >= 3
    # Gu and Eisenstat's vector: w_i = sign(z_i) sqrt(-prod_j delta_ij / (d_i - d_j))
    wv = torch.diagonal(S, dim1=1, dim2=2).clone()
    for j in range(n):
        upd = gram[:, None] & (pos < k[:, None]) & (pos != j) & (j < k[:, None])
        wv = torch.where(upd, wv * (S[:, :, j] / (dlamda - dlamda[:, j : j + 1])), wv)
    wv = torch.copysign(_sqrt(-wv), w)
    Sv = wv[:, :, None] / S  # [B, i, j]
    live = (pos < k[:, None])[:, :, None] & (pos < k[:, None])[:, None, :]
    Sv = torch.where(live, Sv, 0.0)
    acc = torch.zeros((B, n), dtype=torch.float64, device=dev)
    for i in range(n):
        acc = acc + Sv[:, i, :].double() * Sv[:, i, :].double()
    nrm = acc.sqrt().to(_F32)
    perm = Sv.gather(1, indxc[:, :, None].expand(-1, -1, n))
    G = torch.where(gram[:, None, None], perm / nrm[:, None, :], S.gather(1, indxc[:, :, None].expand(-1, -1, n)))
    G = torch.where(live, G, 0.0)
    # sgemm: Q(n1:, :k) = Q2's bottom (types 2, 3) . G(ctot1 :, :k); Q(:n1, :k) = Q2's top (types 1, 2) . G(:n12, :k)
    n12, n23 = ctot[:, 0] + ctot[:, 1], ctot[:, 1] + ctot[:, 2]
    top = torch.zeros((B, n1, n), dtype=_F32, device=dev)
    bot = torch.zeros((B, n - n1, n), dtype=_F32, device=dev)
    for c in range(n):
        ut = (c < n12)[:, None, None]
        top = torch.where(ut, _fma(Qg[:, :n1, c : c + 1], G[:, c : c + 1, :], top), top)
        cb = (ctot[:, 0] + c).clamp(max=n - 1)
        ub = (c < n23)[:, None, None]
        qb = Qg[:, n1:, :].gather(2, cb[:, None, None].expand(-1, n - n1, 1))
        gb = G.gather(1, cb[:, None, None].expand(-1, 1, n))
        bot = torch.where(ub, _fma(qb, gb, bot), bot)
    V = torch.cat([top, bot], 1)
    return lam, V


def _slaed1(d, Q, e_cut, n1: int):
    """LAPACK's slaed1 over a batch of matrices of size n whose halves (cut
    at n1) are solved (d ascending in each half, Q block diagonal); rho =
    e_cut -> (d, Q, indxq) with indxq the 0-based ascending order."""
    B, n = d.shape
    dev = d.device
    pos = torch.arange(n, device=dev)[None]
    z = torch.cat([Q[:, n1 - 1, :n1], Q[:, n1, n1:]], 1)
    indxq = torch.where(pos < n1, pos, pos - n1).expand(B, n).contiguous()
    k, dlamda, w, rho, g_indx, g_indxc, ctot, d, Q, Qg = _slaed2(d, Q, indxq, e_cut, z, n1)
    lam, V = _slaed3(k, dlamda, w, rho, g_indxc, ctot, Qg, n1)
    first = pos < k[:, None]
    d = torch.where(first, lam, d)
    Q = torch.where(first[:, None, :], V, Q)
    merged = _slamrg(d, k, n - k, -1)
    return d, Q, torch.where((k > 0)[:, None], merged, pos.expand(B, n))


def _slanst(d, e):
    vals = torch.cat([d.abs(), e.abs()], 1)
    return torch.where(torch.isnan(vals).any(1), float("nan"), vals.max(1).values)


def _sstedc(d: torch.Tensor, e: torch.Tensor):
    """LAPACK's sstedc with COMPZ = 'I' over a batch: d [B, n], e [B, n - 1]
    -> (eigenvalues ascending, Z [B, n, n], info). n <= SMLSIZ is ssteqr;
    above it the matrix splits where |e_f| <= eps sqrt|d_f| sqrt|d_f+1|;
    a block above SMLSIZ rows (one, for n <= 50) is scaled to norm 1 and
    cut in two (slaed0: the halves' diagonal ends less |e| at the cut),
    the other blocks and the halves are solved by ssteqr (all of one size
    in one call), the halves merged (slaed1), sorted and scaled back, and
    the whole is selection sorted."""
    B, n = d.shape
    if n <= SMLSIZ:
        return _ssteqr(d, e)
    dev = d.device
    Z = torch.eye(n, dtype=_F32, device=dev).expand(B, n, n).clone()
    d, e = d.clone(), e.clone()
    info = torch.zeros(B, dtype=torch.int64, device=dev)
    live = _slanst(d, e) != 0
    tiny = (_EPS * _sqrt(d[:, :-1].abs())) * _sqrt(d[:, 1:].abs())
    cut = (e.abs() <= tiny).tolist()
    jobs, merges = {}, {}  # size -> [(b, first row, block start, block end)]; m -> [(b, start)]
    for b in range(B):
        if not bool(live[b]):
            continue
        start = 0
        for f in range(n):
            if f == n - 1 or cut[b][f]:
                m = f + 1 - start
                if m > SMLSIZ:
                    merges.setdefault(m, []).append((b, start))
                    jobs.setdefault(m // 2, []).append((b, start, start, f))
                    jobs.setdefault(m - m // 2, []).append((b, start + m // 2, start, f))
                elif m > 1:
                    jobs.setdefault(m, []).append((b, start, start, f))
                start = f + 1
    nrms = {}
    for m, rows in merges.items():  # scale the block to norm 1, then the cut
        bi = torch.tensor([r[0] for r in rows], device=dev)
        cd = torch.tensor([r[1] for r in rows], device=dev)[:, None] + torch.arange(m, device=dev)[None]
        db, eb = d[bi[:, None], cd], e[bi[:, None], cd[:, :-1]]
        nrm = _slanst(db, eb)
        for mul, ap in _slascl_steps(nrm, torch.ones_like(nrm), torch.ones_like(live[bi])):
            db = torch.where(ap[:, None], db * mul[:, None], db)
            eb = torch.where(ap[:, None], eb * mul[:, None], eb)
        r = eb[:, m // 2 - 1].abs()
        db[:, m // 2 - 1] = db[:, m // 2 - 1] - r
        db[:, m // 2] = db[:, m // 2] - r
        d[bi[:, None], cd], e[bi[:, None], cd[:, :-1]] = db, eb
        nrms[m] = nrm
    for size, rows in jobs.items():  # every ssteqr of one size at once
        bi = torch.tensor([r[0] for r in rows], device=dev)
        cd = torch.tensor([r[1] for r in rows], device=dev)[:, None] + torch.arange(size, device=dev)[None]
        w, V, inf = _ssteqr(d[bi[:, None], cd], e[bi[:, None], cd[:, :-1]])
        d[bi[:, None], cd] = w
        Z[bi[:, None, None], cd[:, :, None], cd[:, None, :]] = V
        code = torch.tensor([(r[2] + 1) * (n + 1) + r[3] + 1 for r in rows], device=dev)
        info = info.index_put((bi,), torch.where(inf != 0, code, info[bi]))
    for m, rows in merges.items():  # slaed1 on each block, its ascending order, the scale undone
        bi = torch.tensor([r[0] for r in rows], device=dev)
        cd = torch.tensor([r[1] for r in rows], device=dev)[:, None] + torch.arange(m, device=dev)[None]
        dd, Q, indxq = _slaed1(d[bi[:, None], cd], Z[bi[:, None, None], cd[:, :, None], cd[:, None, :]],
                               e[bi, cd[:, m // 2 - 1]], m // 2)
        w = dd.gather(1, indxq)
        for mul, ap in _slascl_steps(torch.ones_like(nrms[m]), nrms[m], torch.ones_like(live[bi])):
            w = torch.where(ap[:, None], w * mul[:, None], w)
        d[bi[:, None], cd] = w
        Z[bi[:, None, None], cd[:, :, None], cd[:, None, :]] = Q.gather(2, indxq[:, None, :].expand(-1, m, -1))
    d, Z = _selection_sort(d, Z, live & (info == 0))
    return d, Z, info


def syevd_ref(G: torch.Tensor):
    """Plain version: ``ssyevd('V', 'L')`` of symmetric f32 [B, n, n] (n <=
    MAX_UNBLOCKED_N) -> (eigenvalues [B, n] ascending, eigenvectors [B, n,
    n] as columns, info [B])."""
    B, n = G.shape[0], G.shape[1]
    if n > MAX_UNBLOCKED_N:
        raise ValueError(f"syevd_ref reproduces ssyevd for n <= {MAX_UNBLOCKED_N}, got {n}")
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
    w, Z, info = _sstedc(d, e)
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
    laid out by kind (4, 2, 1) then rows 0 to MAX_UNBLOCKED_N - 1, and each
    one's start."""
    ops, offs = [], []
    for kind in ("4", "2", "1"):
        for rows in range(MAX_UNBLOCKED_N):
            offs.append(len(ops))
            if rows:
                ops += [op << 6 | r for op, r in _program(kind, rows)]
    offs.append(len(ops))
    return (torch.tensor(ops, dtype=torch.int32, device=device),
            torch.tensor(offs, dtype=torch.int32, device=device))


def syevd(G: torch.Tensor, use_kernels: bool = True):
    """``ssyevd('V', 'L')`` of symmetric f32 [B, n, n] (n <=
    MAX_UNBLOCKED_N) -> (eigenvalues [B, n], eigenvectors [B, n, n], info
    [B] int32). CUDA
    tensors launch ``syevd_small`` (unless ``use_kernels=False``); CPU
    tensors take :func:`syevd_ref`; another device raises."""
    if G.device.type == "cpu" or not use_kernels:
        w, V, info = syevd_ref(G)
        return w, V, info.to(torch.int32)
    B, n = G.shape[0], G.shape[1]
    _native.require(G, "G", _F32, (B, n, n))
    if not 1 <= n <= MAX_UNBLOCKED_N:
        raise ValueError(f"syevd reproduces ssyevd for 1 <= n <= {MAX_UNBLOCKED_N}, got {n}")
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
