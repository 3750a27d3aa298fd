"""LOBSTER (type 37) in the port against the JAX package.

- ``consensus_lobster_ref`` (the plain version of the CUDA kernel) against
  ``consensus_lobster_pallas`` in interpret mode: all five outputs
  bit-exact, C = 1 and 3, a shape that is no tile multiple, and a random
  3×3-only pending log (the shape LOBSTER's step writes).
- The whole algorithm through both packages' ``run_video``: masks, bg
  images and every state leaf bit-exact after every frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal, run_both, to_torch
from tracking_tpu.bgs import lbsp_family as JLF
from tracking_tpu.ops.pallas_consensus import consensus_lobster_pallas
from tracking_tpu_torch.bgs import lbsp_family as TLF
from tracking_tpu_torch.ops import consensus as tc
from tracking_tpu_torch.synth import make_clip


def _inputs(rng, h, w, c, n):
    """Frames, banks near the frame (so the walk finds good samples) and a
    3×3-only pending log: u5 = 0 and the 5×5 fire bit clear."""
    planes = tuple(rng.integers(0, 256, (h, w), np.uint8) for _ in range(c))
    colors = tuple(np.clip(p[None].astype(int) + rng.integers(-20, 21, (n, h, w)), 0, 255).astype(np.uint8)
                   for p in planes)
    # on noise frames most inter-frame bits are set: descriptors with few
    # clear bits make some samples good
    sparse = lambda: np.bitwise_and.reduce(rng.integers(0, 65536, (3, n, h, w)), axis=0)  # noqa: E731
    descs = tuple((0xFFFF & ~sparse()).astype(np.uint16) for _ in range(c))
    upd1 = rng.integers(0, 2, (h, w))
    u3 = np.asarray(JLF.NB3_IN_NB5)[rng.integers(0, 8, (h, w))]
    ctrl = (upd1 | (rng.integers(0, n, (h, w)) << 1) | (u3 << 7) | (rng.integers(0, n, (h, w)) << 17)).astype(np.int32)
    vals = [(rng.integers(0, 256, (h, w)) | (rng.integers(0, 65536, (h, w)) << 8)).astype(np.int32) for _ in range(c)]
    vals[0] = vals[0] | (rng.integers(0, 2, (h, w)) << 24).astype(np.int32)
    return planes, colors, descs, ctrl, tuple(vals)


@pytest.mark.parametrize("c", [1, 3])
def test_consensus_lobster_ref_matches_pallas(c):
    h, w, n = 37, 70, 9
    rng = np.random.default_rng(30 + c)
    planes, colors, descs, ctrl, vals = _inputs(rng, h, w, c, n)
    kw = TLF.LOBSTER()._kernel_kw(c)
    got = tc.consensus_lobster(
        to_torch(planes), to_torch(colors), to_torch(descs), torch.from_numpy(ctrl), to_torch(vals), **kw
    )
    J = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    want = consensus_lobster_pallas(J(planes), J(colors), J(descs), jnp.asarray(ctrl), J(vals), **kw, interpret=True)
    assert_tree_equal(tuple(jax.tree.map(np.asarray, tuple(want))), tuple(got))
    count = got[0].numpy()
    assert (count == kw["req"]).any() and (count < kw["req"]).any()  # both outcomes occur
    assert not all(np.array_equal(a, b.numpy()) for a, b in zip(colors, got[3]))  # the log wrote slots


@pytest.mark.parametrize("c,frames_n", [(3, 16), (1, 12)], ids=["color-48x64", "gray-48x64"])
def test_lobster_matches_reference(c, frames_n):
    frames = make_clip(frames_n, 48, 64, c, seed=20 + c)
    shares, ts = run_both(JLF.LOBSTER(), TLF.LOBSTER(), frames)
    assert 0.0 < np.mean(shares) < 0.5, shares
    assert int(ts["pend_ctrl"].ne(0).sum()) > 0  # the deferred bank writes are exercised
