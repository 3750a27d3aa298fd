"""LOBSTER's consensus on the inputs that stress ``lobster_kernel``'s tile
design, against the TPU kernel it replaces.

``consensus_lobster`` on CPU tensors runs its plain version; the card's
kernel (``csrc/consensus.cu``) replays the pending log through a CT_H x 64
tile's shared copy of the colour slots, walks the tile's first CT_BATCH = 4
samples one thread per pixel, then queues the open walks and walks them
densely (``chip_smoke.py`` phase 3 holds it against the plain version on
these kinds of input at 720p). Here the plain version is held against
``pallas_consensus.consensus_lobster_pallas(interpret=True)``, all five
outputs exactly, C = 1 and 3, N = 9, each case at 24x40 or at a ragged
24x37 (the pairs cover both shapes and both C), where:

- ``req`` = N: no walk stops early;
- the good samples lie only in the last 3 slots;
- the first CT_BATCH slots are bad (and the last one good), so every pixel
  is still open after phase B and the queue holds whole tiles;
- the pending log writes the self write and the spread into the same slot
  (the spread wins), and every pixel spreads, so the border pixels' spreads
  are sourced through the ROI-interior clamp.

A good sample is the pixel's own colour and intra descriptor; a bad one is
its colour with the top bit flipped (a colour distance of at least 128). The
walk cases carry an empty pending log, so that the slots stay as built.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lobster import _inputs
from torch_parity import assert_tree_equal, to_torch
from tracking_tpu.bgs import lbsp_family as JLF
from tracking_tpu.ops.pallas_consensus import consensus_lobster_pallas
from tracking_tpu_torch.bgs import lbsp_family as TLF
from tracking_tpu_torch.ops import consensus as tc

N = 9
CT_BATCH = 4
CASES = ["req = N", "good samples only in the last slots", "every pixel open after CT_BATCH",
         "self write and spread on one slot"]


def _case_inputs(case, C, H, W):
    """(planes, colors, descs, pend_ctrl, pend_vals, kw) numpy arrays and the
    kernel's keyword arguments for one case."""
    rng = np.random.default_rng(11 + C + W)
    planes, colors, descs, ctrl, vals = _inputs(rng, H, W, C, N)
    kw = TLF.LOBSTER()._kernel_kw(C)
    if case == "self write and spread on one slot":
        slot = rng.integers(0, N, (H, W))
        u3 = np.asarray(JLF.NB3_IN_NB5)[rng.integers(0, 8, (H, W))]
        ctrl = (1 | (slot << 1) | (u3 << 7) | (slot << 17)).astype(np.int32)
        fire = (rng.uniform(size=(H, W)) < 0.75).astype(np.int32) << 24
        vals = (vals[0] & ~(3 << 24) | fire,) + vals[1:]
        return planes, colors, descs, ctrl, vals, kw
    thr = JLF.LOBSTER()._thr_fn(C)
    intra = np.asarray(JLF._intra_descriptor(tuple(map(jnp.asarray, planes)), thr)[0]).astype(np.uint16)
    slots = np.arange(N)[:, None, None]
    good = {
        "req = N": rng.uniform(size=(N, H, W)) < 0.6,
        "good samples only in the last slots": slots >= N - 3,
        "every pixel open after CT_BATCH": (slots >= CT_BATCH)
        & ((rng.uniform(size=(N, H, W)) < 0.8) | (slots == N - 1)),
    }[case]
    colors = tuple(np.where(good, p[None], p[None] ^ 0x80).astype(np.uint8) for p in planes)
    descs = tuple(np.where(good, d[None], rng.integers(0, 1 << 16, (N, H, W))).astype(np.uint16) for d in intra)
    if case == "req = N":
        kw["req"] = N
    return planes, colors, descs, np.zeros((H, W), np.int32), vals, kw


@pytest.mark.parametrize(
    "case,C,H,W",
    [(case, C, 24, 40 if (i + (C == 3)) % 2 else 37) for i, case in enumerate(CASES) for C in (1, 3)],
)
def test_lobster_hard_inputs_match_pallas(case, C, H, W):
    planes, colors, descs, ctrl, vals, kw = _case_inputs(case, C, H, W)
    got = tc.consensus_lobster(
        to_torch(planes), to_torch(colors), to_torch(descs), torch.from_numpy(ctrl), to_torch(vals), **kw
    )
    J = lambda t: tuple(map(jnp.asarray, t))  # noqa: E731
    want = consensus_lobster_pallas(J(planes), J(colors), J(descs), jnp.asarray(ctrl), J(vals), **kw, interpret=True)
    assert_tree_equal(tuple(jax.tree.map(np.asarray, tuple(want))), tuple(got), case)
    count, req = got[0].numpy(), kw["req"]
    if case == "req = N":  # walks that fall short and walks that count many
        assert (count < N).any() and (count > N // 2).any()
    elif case == "good samples only in the last slots":  # every walk reaches slot N - 3
        assert req <= 3 and (count == req).all()
    elif case == "every pixel open after CT_BATCH":  # every walk counts past slot CT_BATCH
        assert (count > 0).all() and (count == req).any()
    else:  # the log wrote slots, and both outcomes of the walk occur
        assert not all(np.array_equal(a, b.numpy()) for a, b in zip(colors, got[3]))
        assert (count == req).any() and (count < req).any()
