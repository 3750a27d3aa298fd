"""f32 math as XLA:CPU computes it, for the ports of JAX code that
draws random normals, takes square roots, exponentials, powers, sines,
cosines or arctangents.

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
``sinf``, ``cosf``, ``atan2f`` and ``powf`` (``pow`` and ``cbrt``, which XLA
lowers to ``pow(|x|, f32(1/3))``). :func:`sin` and :func:`cos` write out
glibc's ``sinf`` / ``cosf`` (the range reduction and polynomials computed in
float64, then rounded once), :func:`atan2` glibc's ``atan2f`` (f32
throughout); :func:`powf` takes the power in float64.
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


# glibc's atan2f / atanf (sysdeps/ieee754/flt-32/e_atan2f.c, s_atanf.c: the
# fdlibm float code, every operation in f32), constants as f32 bit patterns
def _f32(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


_ATAN_HI = tuple(_f32(b) for b in (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA))
_ATAN_LO = tuple(_f32(b) for b in (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168))
_ATAN_T = tuple(_f32(b) for b in (0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
                                  0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7))
_PI_O_4, _PI_O_2, _PI, _PI_LO = (_f32(b) for b in (0x3F490FDB, 0x3FC90FDB, 0x40490FDB, 0xB3BBBD2E))


def _ftz(v: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values to zero of the same sign."""
    return torch.where(v.abs() < _MIN_NORMAL, v * 0.0, v)


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``atanf``: the argument reduced to one of four breakpoints,
    an odd and an even polynomial in x², f32 throughout."""
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    a = x.abs()
    one = _c(1.0, x)
    ids = (ix >= 0x3EE00000).to(torch.int32) + (ix >= 0x3F300000) + (ix >= 0x3F980000) + (ix >= 0x401C0000)
    r = torch.where(ids == 1, (a * 2.0 - one) / (a + 2.0), x)
    r = torch.where(ids == 2, (a - one) / (a + one), r)
    r = torch.where(ids == 3, (a - 1.5) / (a * 1.5 + one), r)
    r = torch.where(ids == 4, _c(-1.0, x) / a, r)
    z = r * r
    w = z * z
    s1 = _c(_ATAN_T[10], x)
    for c in _ATAN_T[8::-2]:
        s1 = s1 * w + c
    s1 = z * s1
    s2 = _c(_ATAN_T[9], x)
    for c in _ATAN_T[7::-2]:
        s2 = s2 * w + c
    s2 = w * s2
    small = r - r * (s1 + s2)
    idx = (ids - 1).clamp(min=0).long()
    hi = torch.tensor(_ATAN_HI, dtype=_F32, device=x.device)[idx]
    lo = torch.tensor(_ATAN_LO, dtype=_F32, device=x.device)[idx]
    big = hi - ((r * (s1 + s2) - lo) - r)
    big = torch.where(hx < 0, -big, big)
    out = torch.where(ids == 0, small, big)
    out = torch.where(ix < 0x31000000, x, out)  # |x| < 2**-29: x itself
    limit = _c(float(np.float32(_ATAN_HI[3]) + np.float32(_ATAN_LO[3])), x)  # the f32 sum
    out = torch.where(ix >= 0x4C000000, torch.where(hx < 0, -limit, limit), out)
    return torch.where(ix > 0x7F800000, x + x, out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's f32 ``atan2``: its compiled code calls the C library's
    ``atan2f``, here glibc's (every one of 2**20 random pairs over 16 orders
    of magnitude, a grid around both axes and the signed zeros, infinities
    and NaN agree with ``jax.jit(jnp.arctan2)``). torch's ``atan2`` differs
    from it on ~13 % of those pairs."""
    if y.dtype != _F32 or x.dtype != _F32:
        raise ValueError(f"atan2 takes f32, got {y.dtype} and {x.dtype}")
    y, x = torch.broadcast_tensors(y, x)
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    # XLA:CPU runs with denormals flushed: the branches read the arguments'
    # bits, the quotient sees a subnormal argument or result as zero
    yd, xd = _ftz(y), _ftz(x)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    neg_y, neg_x = hy < 0, hx < 0
    pi, pi_o_2, pi_o_4 = _c(_PI, x), _c(_PI_O_2, x), _c(_PI_O_4, x)

    def signed(v, neg):
        return torch.where(neg, -v, v)

    # the generic case: atanf(|y/x|), placed in its quadrant
    k = (iy - ix) >> 23
    z = _atanf(_ftz(yd / xd).abs())
    z = torch.where(neg_x & (k < -60), _c(0.0, x), z)
    z = torch.where(k > 60, _c(_PI_O_2, x) + _PI_LO * 0.5, z)
    lo = _c(_PI_LO, x)
    out = torch.where(neg_x, torch.where(neg_y, (z - lo) - pi, pi - (z - lo)), signed(z, neg_y))
    out = torch.where(hx == 0x3F800000, _atanf(y), out)  # x = 1
    # an infinite y, then an infinite x, then x = 0, then y = 0
    out = torch.where(iy == 0x7F800000, signed(pi_o_2, neg_y), out)
    inf_inf = torch.where(neg_x, _c(float(np.float32(3.0) * np.float32(_PI_O_4)), x), pi_o_4)
    inf_fin = torch.where(neg_x, pi, _c(0.0, x))
    out = torch.where(ix == 0x7F800000, signed(torch.where(iy == 0x7F800000, inf_inf, inf_fin), neg_y), out)
    out = torch.where(ix == 0, signed(pi_o_2, neg_y), out)
    out = torch.where(iy == 0, torch.where(neg_x, signed(pi, neg_y), y), out)
    return torch.where((ix > 0x7F800000) | (iy > 0x7F800000), x + y, out)


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
    inexact = (err != 0) & torch.isfinite(s)  # an infinite or NaN sum is the FMA's
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


