"""The port's plain consensus (``consensus_ref``, the reference for the CUDA
kernel) against the JAX package: the Pallas kernel ``consensus_pallas`` in
interpret mode, and the XLA branch of the SuBSENSE step (``_apply_pending_xla``
followed by the sample scan). All seven outputs bit-exact, for C = 1 and 3,
shapes that are not tile multiples, a LUT walk of 0 and ≠ 0, random pending
logs and a per-pixel ``required`` map with zeros."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal, to_torch
from tracking_tpu.bgs import lbsp_family as LF
from tracking_tpu.ops import lbsp
from tracking_tpu.ops.pallas_consensus import consensus_pallas
from tracking_tpu_torch.ops import consensus as tc

MIN_CD, DESC_OFF, REL = 30, 3, 0.333


def _inputs(rng, h, w, c, n):
    planes = tuple(rng.integers(0, 256, (h, w), np.uint8) for _ in range(c))
    colors = tuple(rng.integers(0, 256, (n, h, w), np.uint8) for _ in range(c))
    # banks close to the frame so the walk finds good samples
    colors = tuple(np.clip(p[None].astype(int) + rng.integers(-12, 13, (n, h, w)), 0, 255).astype(np.uint8)
                   if i % 2 == 0 else col for i, (p, col) in enumerate(zip(planes, colors)))
    descs = tuple(rng.integers(0, 65536, (n, h, w)).astype(np.uint16) for _ in range(c))
    upd1 = rng.integers(0, 2, (h, w))
    u3 = np.asarray(LF.NB3_IN_NB5)[rng.integers(0, 8, (h, w))]
    ctrl = (upd1 | (rng.integers(0, n, (h, w)) << 1) | (u3 << 7) | (rng.integers(0, 24, (h, w)) << 12)
            | (rng.integers(0, n, (h, w)) << 17) | (rng.integers(0, n, (h, w)) << 23)).astype(np.int32)
    vals = [(rng.integers(0, 256, (h, w)) | (rng.integers(0, 65536, (h, w)) << 8)).astype(np.int32) for _ in range(c)]
    vals[0] = vals[0] | (rng.integers(0, 4, (h, w)) << 24).astype(np.int32)
    R = rng.uniform(1.0, 6.0, (h, w)).astype(np.float32)
    unstable = rng.integers(0, 2, (h, w)).astype(bool)
    required = np.where(rng.uniform(size=(h, w)) < 0.1, 0, 2).astype(np.int32)
    return planes, colors, descs, ctrl, tuple(vals), R, unstable, required


def _xla_reference(planes, colors, descs, ctrl, vals, delta, R, unstable, required, c):
    """The SuBSENSE step's XLA branch (lbsp_family.py:1052-1077)."""
    algo = LF.SuBSENSE()

    @jax.jit
    def run(planes, colors, descs, ctrl, vals, delta, R, unstable, required):
        thr_fn = algo._thr_fn(c, delta)
        colors, descs, bg = LF._apply_pending_xla(ctrl, vals, colors, descs)
        intra, nb = LF._intra_descriptor(planes, thr_fn)
        ct = (R * MIN_CD - jnp.where(unstable, 0, MIN_CD // 5)).astype(jnp.int32)
        ct = ct // 2 if c == 1 else ct
        dt = (1 << jnp.floor(R + 0.5).astype(jnp.int32)) + DESC_OFF + jnp.where(unstable, DESC_OFF, 0)

        def body(carry, sd):
            count, mind, mins = carry
            s_colors, s_descs = sd
            cd, dd = [], []
            for ci in range(c):
                cd.append(jnp.abs(planes[ci].astype(jnp.int16) - s_colors[ci].astype(jnp.int16)).astype(jnp.int32))
                intra_d = lbsp.popcount16(jnp.bitwise_xor(intra[ci], s_descs[ci]))
                inter_d = LF._inter_dist_1ch(nb[ci], s_colors[ci], s_descs[ci], thr_fn)
                dd.append((intra_d + inter_d) // 2)
            if c == 1:
                sum_d = jnp.minimum((dd[0] // 4) * 15 + cd[0], 255)
                good = (cd[0] <= ct) & (dd[0] <= dt) & (sum_d <= ct)
                td, ts = dd[0], sum_d
            else:
                sum_c = [jnp.minimum((dd[i] // 2) * 15 + cd[i], 255) for i in range(c)]
                sc = (ct * 3) // 2
                good = jnp.ones(ct.shape, bool)
                for i in range(c):
                    good &= (cd[i] <= sc) & (sum_c[i] <= sc)
                td, ts = sum(dd), sum(sum_c)
                good = good & (td <= dt * 3) & (ts <= ct * 3)
            live = good & (count < required)
            return (count + live.astype(jnp.int32), jnp.where(live, jnp.minimum(mind, td), mind),
                    jnp.where(live, jnp.minimum(mins, ts), mins)), None

        c0 = (jnp.zeros(ct.shape, jnp.int32), jnp.full(ct.shape, 16 * c, jnp.int32),
              jnp.full(ct.shape, 255 * c, jnp.int32))
        (count, mind, mins), _ = jax.lax.scan(body, c0, (colors, descs))
        return count, mind, mins, tuple(d.astype(jnp.int32) for d in intra), bg, colors, descs

    J = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    return run(J(planes), J(colors), J(descs), J(ctrl), J(vals), jnp.int32(delta), J(R), J(unstable), J(required))


def _consensus_all_three(c, delta, planes, colors, descs, ctrl, vals, R, unstable, required):
    """The port's consensus (its plain version here) beside the Pallas
    kernel in interpret mode and the XLA branch; all seven outputs must be
    equal. Returns the port's."""
    div = 3.0 if c == 1 else 1.0
    hi = float(np.rint(255 * REL))
    got = tc.consensus(
        to_torch(planes), to_torch(colors), to_torch(descs), torch.from_numpy(ctrl), to_torch(vals),
        torch.tensor(delta, dtype=torch.int32), torch.from_numpy(R), torch.from_numpy(unstable),
        torch.from_numpy(required), rel=REL, div=div, hi_const=hi, min_cd=MIN_CD, desc_off=DESC_OFF,
    )
    J = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    pallas = consensus_pallas(
        J(planes), J(colors), J(descs), jnp.asarray(ctrl), J(vals), jnp.int32(delta), jnp.asarray(R),
        jnp.asarray(unstable.astype(np.int32)), required=jnp.asarray(required), rel=REL, div=div, hi_const=hi,
        min_cd=MIN_CD, desc_off=DESC_OFF, interpret=True,
    )
    xla = _xla_reference(planes, colors, descs, ctrl, vals, delta, R, unstable, required, c)
    for ref in (pallas, xla):
        assert_tree_equal(tuple(jax.tree.map(np.asarray, tuple(ref))), tuple(got))
    return got


@pytest.mark.parametrize(
    "c,delta,shape",
    [(1, 0, (37, 70)), (3, 0, (37, 70)), (3, -3, (24, 40)), (3, 5, (37, 70)), (1, 4, (24, 40))],
)
def test_consensus_ref_matches_pallas_and_xla(c, delta, shape):
    h, w = shape
    n = 9
    rng = np.random.default_rng(10 * c + delta + 7)
    planes, colors, descs, ctrl, vals, R, unstable, required = _inputs(rng, h, w, c, n)
    got = _consensus_all_three(c, delta, planes, colors, descs, ctrl, vals, R, unstable, required)
    count = got[0].numpy()
    assert (count == 2).any() and ((count < required) & (required > 0)).any()  # both outcomes occur
    assert not all(np.array_equal(a, b.numpy()) for a, b in zip(colors, got[5]))  # the log wrote slots


@pytest.mark.parametrize("c", [3, 1])
def test_consensus_ref_walks_every_sample(c):
    """required = N at a width that is no multiple of 4 (37 x 74): every
    pixel walks all N samples, the case chip_smoke.py's phase 3 holds the
    kernel to on the card."""
    h, w, n = 37, 74, 9
    rng = np.random.default_rng(60 + c)
    planes, colors, descs, ctrl, vals, R, unstable, _ = _inputs(rng, h, w, c, n)
    required = np.full((h, w), n, np.int32)
    got = _consensus_all_three(c, 0, planes, colors, descs, ctrl, vals, R, unstable, required)
    count = got[0].numpy()
    assert count.max() > 2 and (count < n).any()  # walks past the default requirement, and not all good


def test_apply_pending_matches_xla():
    rng = np.random.default_rng(4)
    planes, colors, descs, ctrl, vals, *_ = _inputs(rng, 29, 45, 3, 11)
    J = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    want = jax.jit(LF._apply_pending_xla)(jnp.asarray(ctrl), J(vals), J(colors), J(descs))
    got = tc.apply_pending_ref(torch.from_numpy(ctrl), to_torch(vals), to_torch(colors), to_torch(descs))
    assert_tree_equal(jax.tree.map(np.asarray, tuple(want)), got)
