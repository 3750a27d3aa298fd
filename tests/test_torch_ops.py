"""The port's plain SuBSENSE ops against the JAX package, bit-exact: LBSP
descriptors, morphology, hole filling, the binary median, the feedback stage,
the pending-log helpers and the model refresh draws.

The JAX side runs under ``jax.jit`` as the SuBSENSE step does: XLA turns a
division by a constant into a product with its f32 reciprocal, which the
port reproduces (``tracking_tpu_torch.ops.consensus.recip``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal, to_torch
from tracking_tpu.bgs import lbsp_family as JLF
from tracking_tpu.ops import filters as jfilters
from tracking_tpu.ops import lbsp as jlbsp
from tracking_tpu.ops import morphology as jmorph
from tracking_tpu.ops import pallas_consensus as jpc
from tracking_tpu.ops import pallas_feedback as jfb
from tracking_tpu_torch.bgs import lbsp_family as TLF
from tracking_tpu_torch.ops import consensus as tcons
from tracking_tpu_torch.ops import feedback as tfb
from tracking_tpu_torch.ops import filters as tfilters
from tracking_tpu_torch.ops import lbsp as tlbsp
from tracking_tpu_torch.ops import morphology as tmorph
from tracking_tpu_torch.ops import rng as trng


def _blob_mask(rng, h, w, holes=True):
    m = np.zeros((h, w), np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        hh, ww = rng.integers(4, 14), rng.integers(4, 18)
        m[y : y + hh, x : x + ww] = 255
        if holes and hh > 6 and ww > 6:
            m[y + 2 : y + hh - 2, x + 2 : x + ww - 2] = 0
            m[y + 3 : y + hh - 3, x + 3 : x + ww - 3] = 255 * (rng.uniform() < 0.3)
    m[rng.uniform(size=(h, w)) < 0.03] = 255  # salt
    return m


@pytest.mark.parametrize("shape,c,delta", [((24, 40), 3, 0), ((37, 70), 1, 0), ((37, 70), 3, -4), ((20, 33), 1, 6)])
def test_lbsp_descriptors(shape, c, delta):
    rng = np.random.default_rng(c + abs(delta))
    planes = tuple(rng.integers(0, 256, shape, np.uint8) for _ in range(c))
    algo = JLF.SuBSENSE()
    d = jnp.int32(delta)
    j_intra, j_nb = jax.jit(lambda p: JLF._intra_descriptor(p, algo._thr_fn(c, d)))(tuple(map(jnp.asarray, planes)))
    t_algo = TLF.SuBSENSE()
    t_intra, t_nb = tcons.intra_descriptors(to_torch(planes), t_algo._thr(c, torch.tensor(delta, dtype=torch.int32)))
    for ci in range(c):
        np.testing.assert_array_equal(t_nb[ci].numpy(), np.asarray(j_nb[ci]))
        np.testing.assert_array_equal(t_intra[ci].numpy(), np.asarray(j_intra[ci]).astype(np.int32))
        np.testing.assert_array_equal(tlbsp.neighbor_stack(torch.from_numpy(planes[ci])).numpy(),
                                      np.asarray(jlbsp.neighbor_stack(jnp.asarray(planes[ci]))))
    words = rng.integers(0, 65536, 4096).astype(np.uint16)
    np.testing.assert_array_equal(tlbsp.popcount16(torch.from_numpy(words.astype(np.int32))).numpy(),
                                  np.asarray(jlbsp.popcount16(jnp.asarray(words))))


@pytest.mark.parametrize("seed", [0, 1])
def test_erode_dilate_close(seed):
    rng = np.random.default_rng(seed)
    m = _blob_mask(rng, 45, 67)
    t = torch.from_numpy(m)
    for jf, tf in ((jmorph.erode, tmorph.erode), (jmorph.dilate, tmorph.dilate), (jmorph.morph_close, tmorph.morph_close)):
        np.testing.assert_array_equal(tf(t, 3).numpy(), np.asarray(jax.jit(lambda x: jf(x, 3))(jnp.asarray(m))))
    chain_j = jax.jit(lambda x: jmorph.erode(jmorph.erode(jmorph.erode(x, 3), 3), 3))(jnp.asarray(m))
    np.testing.assert_array_equal(tmorph.erode(tmorph.erode(tmorph.erode(t))).numpy(), np.asarray(chain_j))


@pytest.mark.parametrize("seed_mode", ["corner", "border"])
def test_fill_holes(seed_mode):
    rng = np.random.default_rng(5)
    for _ in range(3):
        m = _blob_mask(rng, 48, 64)
        want = np.asarray(jmorph.fill_holes(jnp.asarray(m), seed=seed_mode))
        got = tmorph.fill_holes(torch.from_numpy(m), seed=seed_mode).numpy()
        np.testing.assert_array_equal(got, want)
        assert (want > m).any() or seed_mode == "corner"


@pytest.mark.parametrize("ksize", [9, 11, 13])
def test_binary_median_blur(ksize):
    rng = np.random.default_rng(ksize)
    m = _blob_mask(rng, 50, 71)
    want = np.asarray(jax.jit(lambda x: jfilters.binary_median_blur(x, ksize))(jnp.asarray(m)))
    np.testing.assert_array_equal(tfilters.binary_median_blur(torch.from_numpy(m), ksize).numpy(), want)


def _feedback_inputs(rng, h, w, c):
    i32 = lambda lo, hi: rng.integers(lo, hi, (h, w)).astype(np.int32)  # noqa: E731
    f32 = lambda lo, hi: rng.uniform(lo, hi, (h, w)).astype(np.float32)  # noqa: E731
    return dict(
        count=i32(0, 3), mind=i32(0, 16 * c + 1), mins=i32(0, 255 * c + 1), required=np.full((h, w), 2, np.int32),
        roi=i32(0, 2).astype(bool), planes=tuple(i32(0, 256).astype(np.uint8) for _ in range(c)),
        intras=tuple(i32(0, 65536).astype(np.uint16) for _ in range(c)),
        last_colors=tuple(i32(0, 256).astype(np.uint8) for _ in range(c)),
        last_descs=tuple(i32(0, 65536).astype(np.uint16) for _ in range(c)),
        bits=tuple(rng.integers(-(2**31), 2**31, (h, w)).astype(np.int32) for _ in range(4)),
        mean_last=f32(0, 0.05), dmin_lt=f32(0, 1), dmin_st=f32(0, 1), raw_lt=f32(0, 1), raw_st=f32(0.9, 1),
        final_lt=f32(0, 1), final_st=f32(0, 1), R=f32(1, 6), T=f32(2, 256), v=f32(0.1, 20),
        last_final=(i32(0, 2) * 255).astype(np.uint8), blinks_old=i32(0, 2).astype(bool),
        last_blink_mask=i32(0, 2).astype(bool), last_raw=(i32(0, 2) * 255).astype(np.uint8),
        last_dil_inv=i32(0, 2).astype(bool),
    )


@pytest.mark.parametrize("c,use3x3", [(3, True), (3, False), (1, True)])
def test_feedback(c, use3x3):
    rng = np.random.default_rng(c * 2 + use3x3)
    tens = _feedback_inputs(rng, 40, 56, c)
    scalars = (np.float32(1 / 37.0), np.float32(1 / 25.0), np.float32(2.0), np.float32(256.0), np.int32(3))
    k = jfb.FeedbackConsts(0.5, 0.25, 2.0, 1.0, 0.1, 0.01, 3.0, 0.1, 0.995, 0.010)
    want = jax.jit(lambda t, s: jfb.feedback_xla(t, s, C=c, N=50, use3x3_global=use3x3, k=k))(
        jax.tree.map(jnp.asarray, tens), tuple(map(jnp.asarray, scalars))
    )
    got = tfb.feedback(to_torch(tens), to_torch(scalars), C=c, N=50, use3x3_global=use3x3, k=tfb.FeedbackConsts(*k))
    assert tfb.FeedbackOut._fields == jfb.FeedbackOut._fields
    assert_tree_equal(want._asdict(), got._asdict())
    assert np.asarray(want.fire3 | want.fire5).any() and np.asarray(want.upd1).any()  # decisions exercised


def test_pending_helpers():
    rng = np.random.default_rng(3)
    h, w, n = 21, 34, 50
    assert tcons.NB5 == jpc.NB5 and tcons.NB3_IN_NB5 == jpc.NB3_IN_NB5
    o3 = rng.integers(0, 8, (h, w)).astype(np.int32)
    np.testing.assert_array_equal(tcons.nb3_to_nb5_idx(torch.from_numpy(o3)).numpy(),
                                  np.asarray(jpc.nb3_to_nb5_idx(jnp.asarray(o3))))
    fields = (rng.integers(0, 2, (h, w)).astype(bool), rng.integers(0, n, (h, w)), rng.integers(0, 24, (h, w)),
              rng.integers(0, 24, (h, w)), rng.integers(0, n, (h, w)), rng.integers(0, n, (h, w)))
    fields = tuple(f if f.dtype == bool else f.astype(np.int32) for f in fields)
    ctrl_j = jpc.pack_pending_ctrl(*map(jnp.asarray, fields))
    ctrl_t = tcons.pack_pending_ctrl(*to_torch(fields))
    np.testing.assert_array_equal(ctrl_t.numpy(), np.asarray(ctrl_j))
    assert_tree_equal(tuple(np.asarray(x) for x in jpc.unpack_pending_ctrl(ctrl_j)), tcons.unpack_pending_ctrl(ctrl_t))
    planes = tuple(rng.integers(0, 256, (h, w), np.uint8) for _ in range(3))
    intras = tuple(rng.integers(0, 65536, (h, w)).astype(np.uint16) for _ in range(3))
    fires = rng.integers(0, 4, (h, w)).astype(np.uint8)
    vals_j = jpc.pack_pending_vals(tuple(map(jnp.asarray, planes)), tuple(map(jnp.asarray, intras)), jnp.asarray(fires))
    vals_t = tcons.pack_pending_vals(to_torch(planes), to_torch(intras), torch.from_numpy(fires))
    assert_tree_equal(tuple(np.asarray(v) for v in vals_j), vals_t)
    np.testing.assert_array_equal(tcons.interior_rep(vals_t[0]).numpy(), np.asarray(jpc.interior_rep(vals_j[0])))
    for dy, dx in ((2, -2), (-3, 1), (0, 3), (1, 1)):
        np.testing.assert_array_equal(tcons.shift_clamped(vals_t[1], dy, dx).numpy(),
                                      np.asarray(JLF._shift_clamped(vals_j[1], dy, dx)))


def test_refresh_samples():
    """The model refresh (warm start and the auto-reset branch): offset draws
    and the slot writes, with a start slot that wraps."""
    rng = np.random.default_rng(9)
    h, w, c, n = 19, 27, 3, 50
    key = jax.random.PRNGKey(11)
    keyt = trng.prng_key(11)
    np.testing.assert_array_equal(TLF._sample_offset_field(keyt, (5, h, w)).numpy(),
                                  np.asarray(JLF._sample_offset_field(key, (5, h, w))))
    planes = tuple(rng.integers(0, 256, (h, w), np.uint8) for _ in range(c))
    intras = tuple(rng.integers(0, 65536, (h, w)).astype(np.uint16) for _ in range(c))
    ok = rng.uniform(size=(h, w)) < 0.7
    colors = tuple(rng.integers(0, 256, (n, h, w), np.uint8) for _ in range(c))
    descs = tuple(rng.integers(0, 65536, (n, h, w)).astype(np.uint16) for _ in range(c))
    for n_refresh, start in ((5, 47), (n, 0)):
        want = jax.jit(lambda *a: JLF._refresh_samples(key, n, n_refresh, jnp.int32(start), *a))(
            tuple(map(jnp.asarray, planes)), tuple(map(jnp.asarray, intras)), jnp.asarray(ok),
            tuple(map(jnp.asarray, colors)), tuple(map(jnp.asarray, descs)),
        )
        got = TLF._refresh_samples(keyt, n, n_refresh, torch.tensor(start), to_torch(planes), to_torch(intras),
                                   torch.from_numpy(ok), to_torch(colors), to_torch(descs))
        assert_tree_equal(tuple(tuple(np.asarray(x) for x in part) for part in want), got)
