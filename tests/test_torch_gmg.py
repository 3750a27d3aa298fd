"""GMG (type 8) in the port against the JAX package.

- ``gmg_step_ref`` (the plain version of the CUDA kernel) against
  ``gmg_step_pallas`` in interpret mode on random lists: empty and full
  lists, a find at slot 0, in the middle and at the last slot, none; a
  training frame, the last training frame and a frame after training.
- The whole algorithm through both packages' ``run_video`` over 28 frames,
  across the end of training (frame 20).
- The plain step from an empty state on code streams whose lists fill and
  evict, against the Pallas kernel frame by frame, with the invariant the
  CUDA kernel relies on (slots at or past nf hold (-1, +0.0)) checked after
  every step.

Everything is exact, the weights too: the normalisation sum ``total`` is
a float sum whose order moves its last bits (``pallas_gmg.py:15-19``), and
the port takes XLA:CPU's order for a 64-term reduction, runs of 32 in index
order (``ops/gmg.py:blocked_sum``). A sum in plain index order differs from
the reference by up to 6 ulps on these inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import run_both
from tracking_tpu.bgs import gmg as JG
from tracking_tpu.ops.pallas_gmg import gmg_step_pallas
from tracking_tpu_torch.bgs import gmg as TG
from tracking_tpu_torch.ops.gmg import gmg_step
from tracking_tpu_torch.synth import make_clip

K = 64


def _lists(rng, h, w):
    """Random lists with distinct codes per pixel, and a frame code per
    pixel: nf in {0, 1, 5, 32, 63, 64}, the code found at slot 0, nf // 2,
    nf − 1, or nowhere."""
    nf = rng.choice([0, 1, 5, 32, 63, 64], (h, w)).astype(np.int32)
    kk = np.arange(K)[:, None, None]
    codes = (kk * 7919 + rng.integers(0, 4096, (h, w))[None]) % 4096  # distinct in k
    live = kk < nf[None]
    colors = np.where(live, codes, -1).astype(np.int32)
    weights = np.where(live, rng.uniform(0.001, 1.0, (K, h, w)), 0.0).astype(np.float32)
    where = rng.integers(0, 4, (h, w))
    slot = np.select([where == 0, where == 1, where == 2], [0, nf // 2, nf - 1], -1)
    slot = np.where(nf == 0, -1, slot)
    picked = np.take_along_axis(codes, np.maximum(slot, 0)[None], 0)[0]
    code = np.where(slot >= 0, picked, 4096 + rng.integers(0, 100, (h, w))).astype(np.int32)
    return code, nf, colors, weights, slot


@pytest.mark.parametrize("t", [5, 19, 30])
def test_gmg_step_ref_matches_pallas(t):
    h, w = 24, 40
    rng = np.random.default_rng(t)
    code, nf, colors, weights, slot = _lists(rng, h, w)
    cfg = TG.GMGConfig()
    kw = dict(lr=cfg.learningRate, prior=cfg.backgroundPrior, thr=cfg.decisionThreshold,
              init_frames=cfg.initializationFrames)
    got = gmg_step(torch.from_numpy(code), torch.from_numpy(nf), torch.from_numpy(colors),
                   torch.from_numpy(weights), torch.tensor(t, dtype=torch.int32), **kw)
    want = gmg_step_pallas(jnp.asarray(code.view(np.uint32)), jnp.asarray(nf), jnp.asarray(colors.view(np.uint32)),
                           jnp.asarray(weights), jnp.int32(t), **kw, interpret=True)
    want = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(got[0].numpy(), want[0], err_msg="fg")
    np.testing.assert_array_equal(got[1].numpy(), want[1], err_msg="nf1")
    np.testing.assert_array_equal(got[2].numpy().view(np.uint32), want[2], err_msg="colors")
    np.testing.assert_array_equal(got[3].numpy(), want[3], err_msg="weights")
    # every case occurred
    assert ((nf == 0).any() and ((nf == K) & (slot < 0)).any() and ((nf == K) & (slot == K - 1)).any()
            and ((slot == 0) & (nf > 1)).any() and ((slot > 0) & (slot < nf - 1)).any())
    if t >= cfg.initializationFrames:
        assert 0 < int((got[0] > 0).sum()) < h * w


def test_gmg_matches_reference():
    frames = make_clip(29, 48, 64, 3, seed=8)
    shares, ts = run_both(JG.GMG(), TG.GMG(), frames)
    assert max(shares[:20]) == 0.0  # training: empty masks
    assert 0.001 < np.mean(shares[20:]) < 0.5, shares
    assert ts["colors"].dtype == torch.uint32 and int(ts["nf"].max()) > 1


@pytest.mark.parametrize("p_repeat,frames_n", [(0.0, 72), (0.15, 90)], ids=["new-codes", "repeats"])
def test_gmg_lists_fill_and_evict(p_repeat, frames_n):
    """The plain GMG step from an empty state on a code stream whose lists
    fill and then evict: each pixel walks a palette of 97 codes (consecutive
    codes differ), and with ``p_repeat`` takes again a code seen 1-60 frames
    before (a match deep in its list). After every step the slots at or past
    nf hold exactly (-1, +0.0), the invariant the CUDA kernel relies on to
    stop at the list's end; fg every frame and the final state equal the
    interpret-mode Pallas kernel's, bit for bit."""
    h, w = 4, 6
    rng = np.random.default_rng(41)
    cfg = TG.GMGConfig()
    kw = dict(lr=cfg.learningRate, prior=cfg.backgroundPrior, thr=cfg.decisionThreshold,
              init_frames=cfg.initializationFrames)
    offset, stride = rng.integers(0, 97, (h, w)), rng.integers(1, 97, (h, w))
    stream = [(offset + t * stride) % 97 * 41 for t in range(frames_n)]  # distinct within 97 frames
    for t in range(frames_n):
        back = rng.integers(1, 61, (h, w))
        again = (rng.uniform(size=(h, w)) < p_repeat) & (back <= t)
        seen = np.stack([stream[max(t - d, 0)] for d in range(61)])
        picked = np.take_along_axis(seen, np.minimum(back, t)[None], 0)[0]
        stream[t] = np.where(again, picked, stream[t]).astype(np.int32)

    nf = torch.zeros((h, w), dtype=torch.int32)
    colors = torch.full((K, h, w), -1, dtype=torch.int32)
    weights = torch.zeros((K, h, w), dtype=torch.float32)
    j_nf, j_colors, j_weights = jnp.asarray(nf.numpy()), jnp.asarray(colors.numpy().view(np.uint32)), jnp.asarray(
        weights.numpy())
    kidx = torch.arange(K)[:, None, None]
    evicted = deep = 0
    for t, code in enumerate(stream):
        found = (colors == torch.from_numpy(code)[None]) & (kidx < nf[None])
        evicted += int(((nf == K) & ~found.any(0)).sum())
        deep += int((found & (kidx >= 32)).sum())
        fg, nf, colors, weights = gmg_step(torch.from_numpy(code), nf, colors, weights,
                                           torch.tensor(t, dtype=torch.int32), **kw)
        past = kidx >= nf[None]
        assert bool((colors[past.expand(K, h, w)] == -1).all()), f"frame {t}: a colour past nf"
        assert bool((weights[past.expand(K, h, w)].view(torch.int32) == 0).all()), f"frame {t}: a weight past nf"
        j_fg, j_nf, j_colors, j_weights = gmg_step_pallas(jnp.asarray(code.view(np.uint32)), j_nf, j_colors, j_weights,
                                                          jnp.int32(t), **kw, interpret=True)
        np.testing.assert_array_equal(fg.numpy(), np.asarray(j_fg), err_msg=f"fg, frame {t}")
    np.testing.assert_array_equal(nf.numpy(), np.asarray(j_nf), err_msg="nf")
    np.testing.assert_array_equal(colors.numpy().view(np.uint32), np.asarray(j_colors), err_msg="colors")
    np.testing.assert_array_equal(weights.numpy(), np.asarray(j_weights), err_msg="weights")
    assert evicted > 0 and int(nf.min()) == K  # every list filled; some evicted
    if p_repeat:
        assert deep > 0  # matches past the first run of 32 slots
