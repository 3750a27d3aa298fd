"""The fused whole SuBSENSE step in the port against the JAX package.

- ``consensus_feedback_ref`` (through the wrapper ``consensus_feedback`` on
  CPU tensors) against ``pallas_consensus.consensus_feedback_pallas`` in
  interpret mode, on random inputs with a random pending log: every output
  (flags, the new pending log, the eight f32 maps, bg_sum and the banks),
  at t = 0 (last_color / last_desc adopted) and t > 0, with the scalar
  requirement and a random per-pixel map, the 3×3 and 5×5 spread and a
  cooldown that is on and off.
- SuBSENSE with ``TRACKING_TPU_FUSED=1`` against the JAX package with
  ``TRACKING_TPU_FUSED_INTERP=1`` (its interpret-mode kernel on the CPU),
  frame by frame on every state leaf.

All bit-exact. The JAX step reads the switch when it is traced: each case
builds fresh algorithm instances and counts the calls of the JAX kernel
and of the port's wrapper, so both packages provably took the fused branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracking_tpu.ops.pallas_consensus as JPC
from torch_parity import assert_tree_equal, count_calls, run_both, to_torch
from tracking_tpu.bgs import lbsp_family as LF
from tracking_tpu.ops.pallas_feedback import FeedbackConsts as JConsts
from tracking_tpu_torch.bgs import lbsp_family as TLF
from tracking_tpu_torch.ops import consensus as tc
from tracking_tpu_torch.ops.feedback import FeedbackConsts as TConsts
from tracking_tpu_torch.synth import make_clip

MIN_CD, DESC_OFF, REL = 30, 3, 0.333
CONSTS = dict(
    t_incr=LF.FEEDBACK_T_INCR, t_decr=LF.FEEDBACK_T_DECR, t_lower=LF.FEEDBACK_T_LOWER, v_incr=LF.FEEDBACK_V_INCR,
    v_decr=LF.FEEDBACK_V_DECR, r_var=LF.FEEDBACK_R_VAR, rdist_min=LF.UNSTABLE_REG_RDIST_MIN,
    ratio_min=LF.UNSTABLE_REG_RATIO_MIN, ghost_s_min=LF.GHOSTDET_S_MIN, ghost_d_max=LF.GHOSTDET_D_MAX,
)


def _inputs(rng, h, w, c, n, t, req_map):
    planes = tuple(rng.integers(0, 256, (h, w), np.uint8) for _ in range(c))
    colors = tuple(np.clip(p[None].astype(int) + rng.integers(-12, 13, (n, h, w)), 0, 255).astype(np.uint8)
                   for p in planes)
    descs = tuple(rng.integers(0, 65536, (n, h, w)).astype(np.uint16) for _ in range(c))
    upd1 = rng.integers(0, 2, (h, w))
    u3 = np.asarray(LF.NB3_IN_NB5)[rng.integers(0, 8, (h, w))]
    ctrl = (upd1 | (rng.integers(0, n, (h, w)) << 1) | (u3 << 7) | (rng.integers(0, 24, (h, w)) << 12)
            | (rng.integers(0, n, (h, w)) << 17) | (rng.integers(0, n, (h, w)) << 23)).astype(np.int32)
    vals = [(rng.integers(0, 256, (h, w)) | (rng.integers(0, 65536, (h, w)) << 8)).astype(np.int32) for _ in range(c)]
    vals[0] = vals[0] | (rng.integers(0, 4, (h, w)) << 24).astype(np.int32)
    R = rng.uniform(1.0, 6.0, (h, w)).astype(np.float32)
    unstable = rng.integers(0, 2, (h, w)).astype(bool)
    required = rng.choice([2, 7], (h, w)).astype(np.int32) if req_map else 2
    last_color = tuple(rng.integers(0, 256, (h, w), np.uint8) for _ in range(c))
    last_desc = tuple(rng.integers(0, 65536, (h, w)).astype(np.uint16) for _ in range(c))
    bits = rng.integers(-(2**31), 2**31, (4, h, w)).astype(np.int32)
    masks = (np.where(rng.uniform(size=(h, w)) < 0.2, 255, 0).astype(np.uint8), rng.uniform(size=(h, w)) < 0.3,
             rng.uniform(size=(h, w)) < 0.3, np.where(rng.uniform(size=(h, w)) < 0.2, 255, 0).astype(np.uint8),
             rng.uniform(size=(h, w)) < 0.7)
    f = lambda lo, hi: rng.uniform(lo, hi, (h, w)).astype(np.float32)  # noqa: E731
    f32_state = (f(0, 0.02), f(0, 0.5), f(0, 0.5), f(0, 1), f(0.9, 1), f(0, 1), f(0, 1), f(2, 40), f(0.1, 20))
    a_lt = np.float32(1) / np.float32(min(t + 1, 100))
    a_st = np.float32(1) / np.float32(min(t + 1, 25))
    scalars = (a_lt, a_st, np.float32(2.0), np.float32(256.0), np.int32(3 if t else 0), np.int32(t))
    return (planes, colors, descs, ctrl, tuple(vals), R, unstable, required, last_color, last_desc, bits, masks,
            f32_state, scalars)


def _compare_with_pallas(c, t, req_map, use3x3, variant=None):
    """consensus_feedback (the plain version on CPU tensors) against the
    interpret-mode Pallas kernel on ``_inputs``, every output bit for bit;
    ``variant`` rewrites the inputs first: "required=N" sets a requirement
    map of N (every sample is walked), "last3" moves the first N - 3 colour
    slots far from the frame (good samples only in the last 3 slots).
    Returns the port's outputs."""
    h, w, n = 24, 40, 9
    rng = np.random.default_rng(100 + 10 * c + t)
    (planes, colors, descs, ctrl, vals, R, unstable, required, last_color, last_desc, bits, masks, f32_state,
     scalars) = _inputs(rng, h, w, c, n, t, req_map)
    if variant == "required=N":
        required = np.full((h, w), n, np.int32)
    elif variant == "last3":
        colors = tuple(np.concatenate([np.broadcast_to(p[None] ^ 0x80, (n - 3, h, w)), col[n - 3 :]])
                       for p, col in zip(planes, colors))
    kw = dict(rel=REL, div=3.0 if c == 1 else 1.0, hi_const=float(np.rint(255 * REL)), min_cd=MIN_CD,
              desc_off=DESC_OFF, use3x3_global=use3x3)
    J = lambda x: jax.tree.map(jnp.asarray, x)  # noqa: E731
    want = JPC.consensus_feedback_pallas(
        J(planes), J(colors), J(descs), jnp.asarray(ctrl), J(vals), jnp.int32(1), jnp.asarray(R),
        jnp.asarray(unstable), J(required), J(last_color), J(last_desc), jnp.asarray(bits), J(masks), J(f32_state),
        J(scalars), **kw, k_consts=JConsts(**CONSTS), interpret=True,
    )
    T = lambda x: torch.tensor(x) if np.ndim(x) == 0 else torch.from_numpy(np.array(x))  # noqa: E731
    got = tc.consensus_feedback(
        to_torch(planes), to_torch(colors), to_torch(descs), T(ctrl), to_torch(vals), torch.tensor(1, dtype=torch.int32),
        T(R), T(unstable), T(required) if np.ndim(required) else required, to_torch(last_color),
        to_torch(last_desc), T(bits), to_torch(masks), to_torch(f32_state), tuple(T(s) for s in scalars), **kw,
        k=TConsts(**CONSTS),
    )
    assert_tree_equal(jax.tree.map(np.asarray, tuple(want)), tuple(got))
    return got


@pytest.mark.parametrize(
    "c,t,req_map,use3x3",
    [(3, 0, False, True), (3, 7, True, False), (1, 0, True, True), (1, 7, False, False)],
    ids=["C3-t0-scalar-3x3", "C3-t7-map-5x5", "C1-t0-map-3x3", "C1-t7-scalar-5x5"],
)
def test_consensus_feedback_ref_matches_pallas(c, t, req_map, use3x3):
    got = _compare_with_pallas(c, t, req_map, use3x3)
    flags, new_ctrl = got[0].numpy(), got[1].numpy()
    assert 0 < (flags & 1).mean() < 1  # foreground and background
    assert ((flags >> 4) & 1).any() and (new_ctrl & 1).any()  # blinks and self updates
    fire_bit = 1 if use3x3 else 2
    assert ((got[2][0].numpy() >> 24) & fire_bit).any()  # spreads of the chosen kind fire


@pytest.mark.parametrize(
    "c,t,variant",
    [(3, 7, "required=N"), (1, 0, "required=N"), (3, 0, "last3"), (1, 7, "last3")],
    ids=["C3-t7-required-N", "C1-t0-required-N", "C3-t0-last3", "C1-t7-last3"],
)
def test_consensus_feedback_ref_matches_pallas_adversarial(c, t, variant):
    """The inputs the card's check adds for the tile kernel (chip_smoke.py
    ``adversarial_inputs``): a requirement of N and good samples only in the
    last slots, pinned to the reference here."""
    got = _compare_with_pallas(c, t, False, t == 0, variant)
    fg = (got[0].numpy() & 1).astype(bool)
    roi = tc.roi_map(24, 40).numpy()
    assert fg[roi].any() and not fg[~roi].any()
    if variant == "last3":  # some pixels found their 2 good samples in the last 3 slots
        assert (~fg[roi]).any()


def test_fused_switch(monkeypatch):
    for var in ("TRACKING_TPU_FUSED", "TRACKING_TPU_FUSED_INTERP"):
        monkeypatch.delenv(var, raising=False)
    assert not TLF._use_fused()
    monkeypatch.setenv("TRACKING_TPU_FUSED", "0")
    assert not TLF._use_fused()
    monkeypatch.setenv("TRACKING_TPU_FUSED", "1")
    assert TLF._use_fused()
    monkeypatch.delenv("TRACKING_TPU_FUSED")
    monkeypatch.setenv("TRACKING_TPU_FUSED_INTERP", "1")  # the JAX package's interpret-mode switch only
    assert not TLF._use_fused()


@pytest.mark.parametrize("c,frames_n", [(3, 6), (1, 5)], ids=["color-48x64", "gray-48x64"])
def test_subsense_fused_matches_reference(monkeypatch, c, frames_n):
    monkeypatch.setenv("TRACKING_TPU_FUSED", "1")
    monkeypatch.setenv("TRACKING_TPU_FUSED_INTERP", "1")
    j_calls = count_calls(monkeypatch, JPC, "consensus_feedback_pallas")
    t_calls = count_calls(monkeypatch, TLF, "consensus_feedback")
    frames = make_clip(frames_n, 48, 64, c, seed=c + 30)
    shares, ts = run_both(LF.SuBSENSE(), TLF.SuBSENSE(), frames)
    assert len(j_calls) >= 1 and len(t_calls) == frames_n - 1  # both packages took the fused branch
    assert 0.0 < np.mean(shares) < 0.5, shares
    assert int(ts["pend_ctrl"].ne(0).sum()) > 0
