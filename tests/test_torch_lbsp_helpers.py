"""The LBSP descriptor helpers of the port (``ops/lbsp.py``:
``descriptor_bits``, ``pack_bits``, ``unpack_bits``, ``compute_descriptor``,
``hamming16``) against the JAX package's, bit for bit, on seeded u8 images
with per-pixel reference and threshold maps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_tpu.ops import lbsp as JL
from tracking_tpu_torch.ops import lbsp as TL

SHAPES = ((24, 40), (17, 33))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ref = rng.integers(0, 256, shape, dtype=np.uint8)
    thr = rng.integers(0, 60, shape, dtype=np.int32)
    return img, ref, thr


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_descriptor_bits_and_pack(shape):
    img, ref, thr = _inputs(shape, 1)
    jb = JL.descriptor_bits(JL.neighbor_stack(jnp.asarray(img)), jnp.asarray(ref), jnp.asarray(thr))
    tb = TL.descriptor_bits(TL.neighbor_stack(torch.from_numpy(img)), torch.from_numpy(ref), torch.from_numpy(thr))
    _eq(tb, jb)
    _eq(TL.pack_bits(tb), JL.pack_bits(jb))


@pytest.mark.parametrize("shape", SHAPES)
def test_compute_descriptor(shape):
    img, ref, thr = _inputs(shape, 2)
    want = JL.compute_descriptor(jnp.asarray(img), jnp.asarray(ref), jnp.asarray(thr))
    _eq(TL.compute_descriptor(torch.from_numpy(img), torch.from_numpy(ref), torch.from_numpy(thr)), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_unpack_and_hamming(shape):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 16, shape, dtype=np.uint16)
    b = rng.integers(0, 1 << 16, shape, dtype=np.uint16)
    a[0, :4] = (0, 0xFFFF, 0x8000, 1)  # the extreme bit patterns
    b[0, :4] = (0xFFFF, 0xFFFF, 0, 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _eq(TL.unpack_bits(ta), JL.unpack_bits(jnp.asarray(a)))
    _eq(TL.pack_bits(TL.unpack_bits(ta)), a)
    _eq(TL.hamming16(ta, tb), JL.hamming16(jnp.asarray(a), jnp.asarray(b)))
