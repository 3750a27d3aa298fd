"""Random numbers, bit-exact with the JAX package's.

Two generators feed SuBSENSE's stochastic decisions and both must give the
same bits as ``tracking_tpu`` or the sample banks diverge on frame 1:

- JAX's threefry-2x32 key chain (``jax.random.PRNGKey`` / ``split`` /
  ``randint`` / ``key_data``) with ``jax_threefry_partitionable=True``, the
  default of the JAX the reference runs on. Spec: ``jax/_src/prng.py``
  (``threefry_2x32``, ``_threefry_split_foldlike``,
  ``_threefry_random_bits_partitionable``) and ``jax/_src/random.py``
  (``randint`` / ``_randint``).
- the murmur3-finalizer counter field of ``tracking_tpu/ops/rng.py``
  (``field_bits`` / ``field_randint``).

A key is a uint32 tensor of shape ``[..., 2]``, the raw words JAX keeps
(``key_data``). The arithmetic runs in int64 with every result masked to 32
bits: torch has no usable uint32 arithmetic on the CPU. Products of two
32-bit words are split into 16-bit halves so no int64 product overflows.
"""

from __future__ import annotations

import math

import torch

from tracking_tpu_torch.ops.xla_math import erf_inv

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) (int64) and a constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 hash of the counter pair (x1, x2) under key (k1, k2).

    All inputs int64 holding u32 values; k1/k2 are 0-d tensors or ints.
    Returns the two output words (int64, u32 values)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off (JAX's default):
    the seed becomes a 32-bit integer, so the high word is 0."""
    words = [0, int(seed) & _M32]
    return torch.tensor(words, dtype=torch.int64, device=device).to(torch.uint32)


def key_data(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.key_data``: the raw words (keys are kept raw here)."""
    return key


def _words(key: torch.Tensor):
    k = key.to(torch.int64)
    return k[..., 0], k[..., 1]


def _iota(shape, device) -> torch.Tensor:
    return torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(shape)


def _batched(k: torch.Tensor, ndim: int) -> torch.Tensor:
    """A key word of shape B (B = the keys' batch shape) as B + (1,) * ndim,
    to broadcast against a counter of ``ndim`` axes."""
    return k.reshape(tuple(k.shape) + (1,) * ndim)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> uint32 [..., num, 2]; ``key`` is
    one key [2] or a batch of keys [..., 2] (each split as JAX would)."""
    k1, k2 = _words(key)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(_batched(k1, 1), _batched(k2, 1), torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1).to(torch.uint32)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit random words of ``shape`` (int64 holding u32 values), for one
    key [2] or for each of a batch of keys [..., 2] (-> [...] + shape)."""
    shape = tuple(shape)
    k1, k2 = _words(key)
    k1, k2 = _batched(k1, len(shape)), _batched(k2, len(shape))
    # the counter is a 64-bit iota; its high word is 0 below 2**32 elements
    lo = _iota(shape, key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 result).

    The JAX algorithm: split the key, draw a high and a low 32-bit word, and
    fold them into [minval, maxval) with a modulus that uses
    2**32 mod span as the high word's weight."""
    span = maxval - minval
    if span <= 0:
        span = 1
    if not (0 < span <= _M32):
        raise ValueError(f"randint span out of range: {span}")
    keys = split(key, 2)
    higher = random_bits(keys[0], shape)
    lower = random_bits(keys[1], shape)
    # JAX computes both steps in uint32, so the square wraps at 2**32
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    off = ((higher % span) * multiplier + (lower % span)) & _M32
    off = off % span
    return (off + minval).to(torch.int32)


def field_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``tracking_tpu.ops.rng.field_bits``: murmur3 fmix32 over
    (counter, key). Returns int64 holding u32 values."""
    k0, k1 = _words(key)
    x = _iota(tuple(shape), key.device)
    x = (_mul32(x, 0x9E3779B9) + k0) & _M32
    x = x ^ k1
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def field_randint(key: torch.Tensor, shape, lo: int, hi: int) -> torch.Tensor:
    """``tracking_tpu.ops.rng.field_randint``: uniform int32 in [lo, hi)."""
    span = hi - lo
    b = field_bits(key, shape)
    if span & (span - 1) == 0 and span <= (1 << 31):
        r = b & (span - 1)
    else:
        if span > 1 << 16:
            raise ValueError("span too wide for the 16-bit range map")
        r = ((b >> 16) * span) >> 16
    return (r + lo).to(torch.int32)


def as_i32(bits: torch.Tensor) -> torch.Tensor:
    """u32 words (int64) reinterpreted as int32 (``bitcast_convert_type``)."""
    return (bits - ((bits >> 31) << 32)).to(torch.int32)


# -- floats -------------------------------------------------------------------


def _c(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits of a word as a float in [1, 2), minus 1, scaled and shifted in
    f32, floored at ``minval``. ``key`` may be a batch of keys."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _c(minval, floats), _c(maxval, floats)
    return torch.maximum(lo, floats * (hi - lo) + lo)


_NEXT_BELOW_MINUS_ONE = -1.0 + 2.0**-24  # nextafter(-1, 0) in f32
_SQRT2 = 1.4142135381698608  # f32(sqrt(2))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (f32), bit for bit: sqrt(2) *
    erf_inv(u), u uniform in (nextafter(-1, 0), 1), with XLA:CPU's
    ``erf_inv`` (``ops/xla_math.py``). ``key`` may be a batch of keys
    [..., 2] (-> [...] + shape)."""
    u = uniform(key, shape, _NEXT_BELOW_MINUS_ONE, 1.0)
    return _SQRT2 * erf_inv(u)
