"""The v3 read-only walk on the inputs that stress ``read_walk_kernel``'s tile
design, against the TPU kernel it replaces.

``consensus_read`` on CPU tensors runs its plain version; the card's kernel
(``csrc/consensus.cu``) walks a CT_H x 64 tile's first CT_BATCH = 4 samples
one thread per pixel, then queues the open walks and walks them densely
(``chip_smoke.py`` phase 3 holds it against the plain version on these same
kinds of input at 720p). Here the plain version is held against
``pallas_consensus.consensus_read_pallas(interpret=True)``, exactly, at
24x40 and at a ragged 24x37, C = 1 and 3, where:

- ``required`` = N everywhere: no walk stops early;
- the good samples lie only in the last 3 slots;
- ``required`` = 0 everywhere: no sample is examined;
- the first CT_BATCH slots are bad and ``required`` is above CT_BATCH, so
  every pixel is still open after phase B and the queue holds whole tiles.

A good sample is the pixel's own colour and intra descriptor; a bad one is
its colour with the top bit flipped (a colour distance of at least 128).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal, to_torch
from tracking_tpu.bgs import lbsp_family as LF
from tracking_tpu.ops.pallas_consensus import consensus_read_pallas
from tracking_tpu_torch.ops import consensus as tc

MIN_CD, DESC_OFF, REL, DELTA, N = 30, 3, 0.333, 2, 12
CT_BATCH = 4


def _inputs(case, C, H, W):
    """(planes, colors, descs, R, unstable, required) numpy arrays for one case."""
    rng = np.random.default_rng(7 + C + W)
    planes = tuple(rng.integers(0, 256, (H, W), np.uint8) for _ in range(C))
    thr = LF.SuBSENSE()._thr_fn(C, jnp.int32(DELTA))
    intra = np.asarray(LF._intra_descriptor(tuple(map(jnp.asarray, planes)), thr)[0]).astype(np.uint16)
    good = {
        "required = N": rng.uniform(size=(N, H, W)) < 0.6,
        "good samples only in the last slots": np.arange(N)[:, None, None] >= N - 3,
        "required = 0": rng.uniform(size=(N, H, W)) < 0.5,
        "every pixel open after CT_BATCH": (np.arange(N)[:, None, None] >= CT_BATCH)
        & (rng.uniform(size=(N, H, W)) < 0.8),
    }[case]
    colors = tuple(np.where(good, p[None], p[None] ^ 0x80).astype(np.uint8) for p in planes)
    descs = tuple(np.where(good, d[None], rng.integers(0, 1 << 16, (N, H, W))).astype(np.uint16) for d in intra)
    required = {
        "required = N": N,
        "good samples only in the last slots": 2,
        "required = 0": 0,
        "every pixel open after CT_BATCH": CT_BATCH + 2,
    }[case]
    R = rng.uniform(1.0, 6.0, (H, W)).astype(np.float32)
    unstable = rng.integers(0, 2, (H, W)).astype(bool)
    return planes, colors, descs, R, unstable, np.full((H, W), required, np.int32)


@pytest.mark.parametrize("H,W", [(24, 40), (24, 37)])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize(
    "case", ["required = N", "good samples only in the last slots", "required = 0", "every pixel open after CT_BATCH"]
)
def test_read_walk_hard_inputs_match_pallas(case, C, H, W):
    planes, colors, descs, R, unstable, required = _inputs(case, C, H, W)
    div = 3.0 if C == 1 else 1.0
    hi = float(np.rint(255 * REL))
    kw = dict(rel=REL, div=div, hi_const=hi, min_cd=MIN_CD, desc_off=DESC_OFF)
    got = tc.consensus_read(
        to_torch(planes), to_torch(colors), to_torch(descs), torch.tensor(DELTA, dtype=torch.int32),
        torch.from_numpy(R), torch.from_numpy(unstable), torch.from_numpy(required), **kw,
    )
    J = lambda t: tuple(map(jnp.asarray, t))  # noqa: E731
    want = consensus_read_pallas(
        J(planes), J(colors), J(descs), jnp.int32(DELTA), jnp.asarray(R), jnp.asarray(unstable.astype(np.int32)),
        required=jnp.asarray(required), interpret=True, **kw,
    )
    assert_tree_equal(tuple(jax.tree.map(np.asarray, tuple(want))), tuple(got), case)
    count = got[0].numpy()
    if case == "required = N":  # walks that fall short and walks that count many
        assert (count < N).any() and (count > N // 2).any()
    elif case == "required = 0":
        assert (count == 0).all()
    elif case == "good samples only in the last slots":  # every walk reaches slot N - 2
        assert (count == required).all()
    else:  # every walk counts past slot CT_BATCH, most reach their requirement
        assert (count > 0).all() and (count == required).any()
