"""f32 math as XLA:CPU computes it, for the ports of JAX code that
draws random normals, takes square roots, exponentials, powers, sines or
cosines.

The reference's numbers are XLA:CPU's. XLA lowers ``sqrt`` to a correctly
rounded square root and expands ``erf_inv`` into f32 multiplies, adds, a
square root and ``log1p``; XLA:CPU computes ``log1p`` with its own
approximation (the Cephes polynomials), not the C library's, and its
compiled code contracts the multiply-adds inside it into FMAs. torch's CPU
``log1p`` differs from it by up to 2 ulp on 8 % of the arguments and
torch's CPU ``sqrt`` is not correctly rounded. The functions below write
out XLA's operations one by one, with the constants XLA's code holds, so
they are bit for bit XLA:CPU's on the CPU and on the card alike: each HLO op
rounds once (with fusion off XLA runs each in its own kernel), and each
fused multiply-add rounds once (:func:`fma`).

Some ops XLA:CPU does not expand: its compiled code calls the C library's
``sinf``, ``cosf`` and ``powf`` (``pow`` and ``cbrt``, which XLA lowers to
``pow(|x|, f32(1/3))``). :func:`sin` and :func:`cos` write out glibc's
``sinf`` / ``cosf`` (the range reduction and polynomials computed in
float64, then rounded once); :func:`powf` takes the power in float64.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_F32 = torch.float32


def _c(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=_F32, device=like.device)


def _hx(bits: int) -> float:
    """An f32 constant given as the bits of the double that holds it (the
    form LLVM IR prints f32 constants in)."""
    return struct.unpack(">d", bits.to_bytes(8, "big"))[0]


# XLA's log(y) for f32, y = 2**e * m: the Cephes polynomial in m - 1
_LOG_Y1 = tuple(_hx(h) for h in (0x3FB2043760000000, 0xBFBD7A3700000000, 0x3FBDE4A340000000))
_LOG_Y2 = tuple(_hx(h) for h in (0xBFBFCBA9E0000000, 0x3FC23D37E0000000, 0xBFC555CA00000000))
_LOG_Y3 = tuple(_hx(h) for h in (0x3FC999D580000000, 0xBFCFFFFF80000000, 0x3FD5555540000000))
_LOG_Q1, _LOG_Q2 = _hx(0xBF2BD01060000000), _hx(0x3FE6300000000000)  # -2.12194440e-4, 0.693359375
_SQRTHF = _hx(0x3FE6A09E60000000)
_MIN_NORMAL = _hx(0x3810000000000000)
# log1p(x) for |x| < sqrt(2) - 1: x - x^2 / 2 + x^3 P(x) / Q(x)
_L1P_SMALL = _hx(0x3FDA8279A0000000)
_L1P_P = tuple(_hx(h) for h in (0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000, 0x403DE97380000000,
                                0x404E798EC0000000, 0x404C8E75A0000000, 0x40340A2020000000))
_L1P_Q = tuple(_hx(h) for h in (0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000, 0x4073519460000000,
                                0x406B0DB140000000, 0x404E0F3040000000))
# exp(x) = 2**n * (1 + r + r^2 P(r)), n = floor(x log2(e) + 1/2), r = x - n ln 2
# (ln 2 split as _LOG_Q2 - _LOG_Q1); x clamped to [-87.8, 88.8] first
_EXP_LO, _EXP_HI = _hx(0xC055F33340000000), _hx(0x4056333340000000)
_LOG2E = _hx(0x3FF7154760000000)
_EXP_P = tuple(_hx(h) for h in (0x3F2A0D2CE0000000, 0x3F56E879C0000000, 0x3F81112100000000, 0x3FA5553820000000,
                                0x3FC5555540000000))


# glibc's sinf / cosf (sysdeps/ieee754/flt-32/sincosf.h): |x| < 0.75 (the
# top 12 bits of |x| below those of pi/4) goes to the polynomials directly;
# below 120 the quadrant n comes from x * (2/pi * 2**24) truncated to an
# int32, and x - n * pi/2 is the reduced argument; the polynomials in
# float64, the result rounded to f32 once
_PI2_INV_2_24 = float.fromhex("0x1.45F306DC9C883p+23")
_PI2 = float.fromhex("0x1.921FB54442D18p0")
_SIN_S = tuple(float.fromhex(h) for h in ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))
_COS_C = tuple(float.fromhex(h) for h in ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
                                          "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))


def _sincos(y: torch.Tensor, cos: bool) -> torch.Tensor:
    if y.dtype != _F32:
        raise ValueError(f"sin / cos take f32, got {y.dtype}")
    top12 = (y.view(torch.int32) >> 20) & 0x7FF
    x = y.to(torch.float64)
    near = top12 < 0x3F4  # |x| < 0.75
    n = ((x * _PI2_INV_2_24).to(torch.int32) + 0x800000) >> 24
    n = torch.where(near, 0, n)
    r = x - n.to(torch.float64) * _PI2
    r = torch.where(near, x, r)
    # the sine's sign by quadrant, and the cosine polynomial negated in
    # quadrants 2 and 3
    r = torch.where((n & 3) % 3 == 0, r, -r)
    c_sign = torch.where((n & 2) != 0, -1.0, 1.0).to(torch.float64)
    q = n ^ 1 if cos else n
    r2 = r * r
    r3 = r * r2
    s = r + r3 * _SIN_S[0]
    s = s + (r3 * r2) * (_SIN_S[1] + r2 * _SIN_S[2])
    r4 = r2 * r2
    c2 = _COS_C[3] + r2 * _COS_C[4]
    c = (_COS_C[0] + r2 * _COS_C[1]) + r4 * _COS_C[2]
    c = (c + (r4 * r2) * c2) * c_sign
    out = torch.where((q & 1) != 0, c, s).to(_F32)
    tiny = top12 < 0x398  # |x| < 2**-12: sinf returns x, cosf 1
    return torch.where(tiny, torch.ones_like(y) if cos else y, out)


def sin(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``sin`` (glibc's ``sinf``): the same bits for every f32
    with |x| < 17 (each one checked against glibc 2.36); from there to 120
    a few arguments differ in the last bit (glibc's build contracts
    x − n·π/2 into an FMA). torch's ``sin`` differs from it on ~5 % of f32
    in [0, 2π]."""
    return _sincos(x, cos=False)


def cos(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``cos`` (glibc's ``cosf``), as :func:`sin`."""
    return _sincos(x, cos=True)


def powf(t: torch.Tensor, e: float) -> torch.Tensor:
    """``t ** e`` for positive f32 ``t``: XLA:CPU calls the C library's
    ``powf``; the port takes the power in float64 with the f32 exponent and
    rounds once, which agrees with it on every gamma input and all but a
    few cube roots (the Lab test states the residue)."""
    return t.to(torch.float64).pow(float(np.float32(e))).to(_F32)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as XLA's (torch's CPU ``sqrt``
    is not: it differs in the last bit on ~0.7 % of f32 arguments in
    [5, 20]). The f64 root rounded to f32 is correctly rounded."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def fma(a, b, c) -> torch.Tensor:
    """f32 a * b + c rounded once (the FMA XLA:CPU's compiled ``log1p``
    uses). In f64 the product is exact; the sum's rounding error (TwoSum)
    makes it round to odd, after which rounding to f32 is exact."""
    ref = next(t for t in (a, b, c) if isinstance(t, torch.Tensor))
    a, b, c = (t.to(torch.float64) if isinstance(t, torch.Tensor) else torch.tensor(t, dtype=torch.float64, device=ref.device)
               for t in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact = err != 0
    bits = s.view(torch.int64)
    bits = bits - (inexact & ((err < 0) != (s < 0))).to(torch.int64)  # s truncated toward zero
    return (bits | inexact.to(torch.int64)).view(torch.float64).to(_F32)


def _log(y: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log`` (its polynomial, special values included)."""
    yc = torch.where(y > _MIN_NORMAL, y, _c(_MIN_NORMAL, y))
    bits = yc.view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(_F32)  # mantissa in [0.5, 1)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    small = m < _SQRTHF
    e = torch.where(small, e + -1.0, e)
    x = (m + -1.0) + torch.where(small, m, _c(0.0, y))
    z = x * x
    z3 = z * x
    y1 = fma(fma(x, _LOG_Y1[0], _LOG_Y1[1]), x, _LOG_Y1[2])
    y2 = fma(fma(x, _LOG_Y2[0], _LOG_Y2[1]), x, _LOG_Y2[2])
    y3 = fma(fma(x, _LOG_Y3[0], _LOG_Y3[1]), x, _LOG_Y3[2])
    t = fma(z3, fma(z3, fma(z3, y1, y2), y3), e * _LOG_Q1)
    r = fma(e, _LOG_Q2, fma(z, -0.5, x) + t)
    r = torch.where((y <= 0) | torch.isnan(y), _c(float("nan"), y), r)
    r = torch.where(y == 0, _c(float("-inf"), y), r)
    return torch.where(y == float("inf"), _c(float("inf"), y), r)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``log1p``: for |x| < sqrt(2) - 1 the rational
    x - x^2 / 2 + x^3 P(x) / Q(x), else its ``log(1 + x)``; multiply-adds
    as the compiled code contracts them."""
    q = x + _L1P_Q[0]
    for c in _L1P_Q[1:]:
        q = fma(q, x, c)
    pn = _c(_L1P_P[0], x)
    for c in _L1P_P[1:]:
        pn = fma(pn, x, c)
    x2 = x * x
    small = x + fma(x2, -0.5, (x2 * x) * (pn / q))
    return torch.where(x.abs() < _L1P_SMALL, small, _log(x + 1.0))


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``exp`` (the Cephes range reduction and polynomial,
    multiply-adds contracted as its compiled code does; torch's CPU ``exp``
    differs from it by 1 ulp on ~9 % of arguments in [-5, 0]). The clamp
    bounds the scale 2**n to [2**-127, 2**127] (2**-127 is encoded as +0),
    and XLA:CPU flushes subnormal results to zero, so exp(x) is 0 for
    x below about -87.34 and inf above about 88.72."""
    xc = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma(xc, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(-n, _LOG_Q2, xc)
    r = fma(-n, _LOG_Q1, r)
    y = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:] + (0.5,):
        y = fma(y, r, c)
    y = fma(y, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(_F32)
    e = y * scale
    return torch.where(e < _MIN_NORMAL, _c(0.0, x), e)


# erf_inv (XLA's ErfInv32, Giles' approximation): coefficient pairs for
# w < 5 and w >= 5, highest degree first
_ERFINV = (
    (2.81022636e-08, -0.000200214257), (3.43273939e-07, 0.000100950558), (-3.5233877e-06, 0.00134934322),
    (-4.39150654e-06, -0.00367342844), (0.00021858087, 0.00573950773), (-0.00125372503, -0.0076224613),
    (-0.00417768164, 0.00943887047), (0.246640727, 1.00167406), (1.50140941, 2.83297682),
)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` for f32, op for op as XLA expands it."""
    w = -log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w + -2.5, sqrt(w) + -3.0)
    p = torch.where(lt, _c(_ERFINV[0][0], x), _c(_ERFINV[0][1], x))
    for lo, hi in _ERFINV[1:]:
        p = torch.where(lt, _c(lo, x), _c(hi, x)) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


