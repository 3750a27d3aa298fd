"""The port's random numbers (tracking_tpu_torch/ops/rng.py) against JAX:
the threefry key chain (PRNGKey / split / randint / key_data) and the
counter-hash field (field_bits / field_randint), all bit-exact.

The threefry bits depend on ``jax_threefry_partitionable``; the tests pin it
to True, the setting the reference runs with."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_tpu.ops import rng as jrng
from tracking_tpu_torch.ops import rng

SEEDS = [0, 7, 42, 2**31 - 1]


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_key_data(seed):
    k = jax.random.PRNGKey(seed)
    kt = rng.prng_key(seed)
    assert kt.dtype == torch.uint32
    np.testing.assert_array_equal(kt.numpy(), np.asarray(jax.random.key_data(k)))
    np.testing.assert_array_equal(rng.key_data(kt).numpy(), np.asarray(k))
    for n in (2, 3, 12):
        np.testing.assert_array_equal(rng.split(kt, n).numpy(), np.asarray(jax.random.split(k, n)))
    # a chain of splits, as the SuBSENSE step carries its key
    for _ in range(4):
        k = jax.random.split(k, 12)[0]
        kt = rng.split(kt, 12)[0]
    np.testing.assert_array_equal(kt.numpy(), np.asarray(k))


@pytest.mark.parametrize(
    "shape,lo,hi",
    [
        ((), 0, 50),  # the refresh start slot
        ((50, 7, 9), 1, 513),  # the warm-start offset draw
        ((5, 11), -3, 1000003),  # a span that is not a power of two
        ((4, 6), 0, 64),  # a power-of-two span
        ((3,), 0, 2**30),
        ((8,), 0, 70000),  # span above 2**16: the squared weight wraps
    ],
)
def test_randint(shape, lo, hi):
    for seed in SEEDS[:3]:
        k = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(k, shape, lo, hi))
        got = rng.randint(rng.prng_key(seed), shape, lo, hi).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(0, 50), (0, 8), (0, 24), (0, 64), (0, 2**30), (3, 27)])
def test_field_bits_and_randint(lo, hi):
    shape = (4, 9, 13)
    for seed in SEEDS:
        k = jax.random.split(jax.random.PRNGKey(seed), 12)[2]
        kt = rng.split(rng.prng_key(seed), 12)[2]
        bits = rng.field_bits(kt, shape)
        np.testing.assert_array_equal(bits.numpy().astype(np.uint32), np.asarray(jrng.field_bits(k, shape)))
        np.testing.assert_array_equal(
            rng.as_i32(bits).numpy(),
            np.asarray(jax.lax.bitcast_convert_type(jrng.field_bits(k, shape), jnp.int32)),
        )
        np.testing.assert_array_equal(
            rng.field_randint(kt, shape, lo, hi).numpy(), np.asarray(jrng.field_randint(k, shape, lo, hi))
        )


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_normal_and_uniform_over_many_keys():
    """``rng.normal`` / ``rng.uniform`` for a batch of 2,000 keys (MSPF draws
    per-track normals from a batch of keys) against ``jax.random.normal`` /
    ``uniform``: bit for bit. The residue is printed (0 ulp)."""
    keys = np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.arange(2000)))
    tk = torch.from_numpy(keys.copy())
    want = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.normal(k, (128,))))(keys))
    got = rng.normal(tk, (128,)).numpy()
    print(f"normal: {int((_ulps(want, got) > 0).sum())} of {want.size} draws differ, max {_ulps(want, got).max()} ulp")
    np.testing.assert_array_equal(got, want)
    want_u = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.uniform(k, (64,), minval=-2.0, maxval=3.0)))(keys))
    np.testing.assert_array_equal(rng.uniform(tk, (64,), -2.0, 3.0).numpy(), want_u)
    np.testing.assert_array_equal(rng.split(tk, 3).numpy(), np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys)))
    for seed in SEEDS:  # one key, as the tracker's state holds it
        np.testing.assert_array_equal(rng.normal(rng.prng_key(seed), (16,)).numpy(),
                                      np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (16,))))


def test_xla_math_on_dense_grids():
    """``ops/xla_math``: ``log1p`` on 1e6 f32 arguments in [-1, 3] and on
    both sides of its branch point, ``erf_inv`` on a 2e6-point grid of
    [-1, 1] (its two branches and +-1), ``sqrt`` on [0, 1e6]: bit for bit
    XLA:CPU's (torch's own ``log1p`` and CPU ``sqrt`` are not)."""
    from tracking_tpu_torch.ops import xla_math

    g = np.random.default_rng(0)
    x = np.concatenate([g.uniform(-1, 3, 1_000_000), np.linspace(-0.4143, 0.4143, 10_001)]).astype(np.float32)
    np.testing.assert_array_equal(xla_math.log1p(torch.from_numpy(x)).numpy(), np.asarray(jax.jit(jnp.log1p)(x)))
    u = np.linspace(-1, 1, 2_000_001, dtype=np.float32)
    np.testing.assert_array_equal(xla_math.erf_inv(torch.from_numpy(u)).numpy(), np.asarray(jax.jit(jax.lax.erf_inv)(u)))
    s = g.uniform(0, 1e6, 1_000_000).astype(np.float32)
    np.testing.assert_array_equal(xla_math.sqrt(torch.from_numpy(s)).numpy(), np.asarray(jax.jit(jnp.sqrt)(s)))


def test_xla_exp():
    """``ops/xla_math.exp`` bit for bit against ``jax.jit(jnp.exp)`` (torch's
    CPU ``exp`` differs by 1 ulp on ~9 % of [-5, 0], the range the lb fuzzy
    models feed it): every f32 of a 2e6-point grid of [-5, 0], 2^20 random
    f32 in [-104, 89], the edges where the result overflows to inf and
    where it turns subnormal (XLA:CPU flushes those to 0), and the special
    values."""
    from tracking_tpu_torch.ops import xla_math

    def check(x):
        np.testing.assert_array_equal(xla_math.exp(torch.from_numpy(x)).numpy(), np.asarray(jax.jit(jnp.exp)(x)))

    check(np.linspace(-5, 0, 2_000_001, dtype=np.float32))
    check(np.random.default_rng(3).uniform(-104, 89, 1 << 20).astype(np.float32))
    check(np.linspace(-88.8, -86.0, 200_001, dtype=np.float32))  # down to 0 through the subnormal range
    check(np.linspace(88.0, 89.0, 100_001, dtype=np.float32))  # up to inf
    f = np.finfo(np.float32)
    special = [0.0, -0.0, np.inf, -np.inf, np.nan, -87.8, -87.80001, -87.33654, -87.33655, 88.72283, 88.72284, 88.8,
               88.80001, -104.0, f.tiny, -f.tiny, f.smallest_subnormal, -f.smallest_subnormal, f.max, -f.max]
    check(np.array(special, dtype=np.float32))
    assert float(xla_math.exp(torch.tensor(-87.5))) == 0.0  # a subnormal result flushed
    x = torch.from_numpy(np.linspace(-5, 0, 2_000_001, dtype=np.float32))
    assert (torch.exp(x) != xla_math.exp(x)).float().mean() > 0.05  # torch's own exp is not XLA's
