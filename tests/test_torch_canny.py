"""Canny (``ops/canny``) and MultiCue's colour front end against the JAX
package: the edge map of ``tracking_tpu.ops.canny.canny`` on random and
smooth images and on long chains of weak edges that one strong pixel
holds, the component-labelling hysteresis against its dilation fixed point,
and ``_hsv_xyz`` and the XLA:CPU ``sin`` / ``cos`` (``ops/xla_math``) bit
for bit over all 2^24 BGR colours."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_tpu.bgs import multicue as JMC
from tracking_tpu.ops.canny import canny as jcanny
from tracking_tpu_torch.bgs import multicue as TMC
from tracking_tpu_torch.ops import canny as TC
from tracking_tpu_torch.ops import xla_math


def images():
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (37, 53), np.uint8)
    y, x = np.mgrid[:40, :64]
    smooth = (127 + 60 * np.sin(x / 5.0) * np.cos(y / 7.0) + rng.normal(0, 6, (40, 64))).clip(0, 255).astype(np.uint8)
    # a serpentine band 30 levels above the background (|gx| + |gy| of a
    # 30-step: 120, weak) whose first row steps by 60 (strong): hysteresis
    # has to walk the whole chain
    chain = np.zeros((41, 60), np.uint8)
    for r in range(2, 39, 4):
        chain[r : r + 2, 3:57] = 30
        chain[r + 2 : r + 4, (57 if (r // 4) % 2 == 0 else 3) - 1 : (57 if (r // 4) % 2 == 0 else 3) + 1] = 30
    chain[2:4, 3:10] = 60
    blocks = np.kron(rng.integers(0, 4, (6, 8)) * 50, np.ones((7, 7), np.int64)).astype(np.uint8)
    return {"noise": noise, "smooth": smooth, "chain": chain, "blocks": blocks}


@pytest.mark.parametrize("name", list(images()))
def test_canny_matches_reference(name):
    img = images()[name]
    want = np.asarray(jax.jit(jcanny)(jnp.asarray(img)))
    got = TC.canny(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any()
    if name == "chain":  # most of the chain is reached only through weak pixels
        strong, weak = TC._peaks(torch.from_numpy(img), 100.0, 150.0)
        assert int((torch.from_numpy(got > 0) & ~strong).sum()) > 10 * int(strong.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hysteresis_is_the_dilation_fixed_point(seed):
    rng = np.random.default_rng(seed)
    weak = torch.from_numpy(rng.uniform(size=(45, 70)) < 0.5)
    strong = weak & torch.from_numpy(rng.uniform(size=(45, 70)) < 0.02)
    want = TC.hysteresis_ref(strong, weak)
    got = TC.hysteresis(strong, weak)
    assert torch.equal(got, want) and bool(want.any()) and not torch.equal(want, weak)


def all_colours(chunk: int):
    """The 2^24 BGR colours as [chunk, 4096, 3] u8 images."""
    v = np.arange(1 << 24, dtype=np.uint32)
    bgr = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    for r in range(0, 4096, chunk):
        yield bgr[r : r + chunk]


def test_hsv_xyz_all_colours():
    jf = jax.jit(JMC._hsv_xyz)
    for img in all_colours(512):
        np.testing.assert_array_equal(TMC._hsv_xyz(torch.from_numpy(img)).numpy(), np.asarray(jf(jnp.asarray(img))))


def test_xla_sin_cos_all_colours():
    """sin / cos of the hue angle of every colour (the values MultiCue
    takes them of), and of 10^6 random f32 in [-8, 8]."""
    js, jc = jax.jit(jnp.sin), jax.jit(jnp.cos)

    def hue_angle(img):
        b, g, r = (torch.from_numpy(img[..., i]).to(torch.float32) * TMC._INV255 for i in range(3))
        mx, mn = torch.maximum(torch.maximum(r, g), b), torch.minimum(torch.minimum(r, g), b)
        s = torch.where(mx == 0, 0.0, (mx - mn) / torch.where(mx == 0, 1.0, mx))
        safe = torch.where(s == 0, 1.0, s)
        h_r = 60.0 * (g - b) / safe
        h_r = torch.where(h_r < 0, 360.0 + h_r, h_r)
        hh = torch.where(mx == r, h_r, torch.where(mx == g, 120.0 + 60.0 * (b - r) / safe, 240.0 + 60.0 * (r - g) / safe))
        return torch.unique(hh * TMC._HRAD)

    xs = torch.cat([hue_angle(img) for img in all_colours(1024)] + [
        torch.from_numpy(np.random.default_rng(0).uniform(-8, 8, 10**6).astype(np.float32))])
    x = jnp.asarray(xs.numpy())
    for port, ref in ((xla_math.sin, js), (xla_math.cos, jc)):
        np.testing.assert_array_equal(port(xs).numpy().view(np.int32), np.asarray(ref(x)).view(np.int32))
