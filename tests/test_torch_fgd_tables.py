"""FGD's Bayes-table phase in the port against the JAX package, exactly.

- ``fgd_tables_ref`` (the plain version of the CUDA kernel) against
  ``fgd_tables_pallas`` in interpret mode and against the XLA formulation
  ``_tables_phase``, on random tables at 24×40 and at 26×70 (which the TPU
  kernel pads), with f16 and f32 statistics, on a later frame and on the
  first. The tables are built so that every case occurs, and the test
  asserts that it did: no match, a match at entry 0, in the middle and at
  the last entry, two matching entries (the first wins), a matching key on
  an unused entry (P = 0, no match), equal P at the match (the rank tie)
  and at the least P (the argmin tie), a full table replaced, changed
  pixels and not, and ``fg_age`` 29 → 30 (absorbed).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal, to_torch
from tracking_tpu.bgs import fgd as JF
from tracking_tpu.ops.pallas_fgd import fgd_tables_pallas
from tracking_tpu_torch.bgs.fgd import FGDConfig
from tracking_tpu_torch.ops.fgd import TABLE_LEAVES, fgd_tables

CFG = FGDConfig()
P_VALUES = np.array([0.005, 0.00995, 0.02, 0.1, 0.25, 0.5, 0.75], np.float32)  # few values: many ties


def _table(rng, N, Ck, h, w, dtype):
    """A random table and a pixel key per pixel. Entry n's first key byte is
    n, so keys are distinct unless a case copies one; the pixel's key is
    entry ``slot``'s (slot −1: byte 0 is 63, matching nothing)."""
    keys = rng.integers(0, 64, (N, Ck, h, w)).astype(np.uint8)
    keys[:, 0] = np.arange(N, dtype=np.uint8)[:, None, None]
    P = rng.choice(P_VALUES, (N, h, w))
    P = np.where(rng.random((h, w)) < 0.3, np.where(rng.random((N, h, w)) < 0.4, 0.0, P), P)  # unused entries
    Pb = P * rng.choice(np.array([0.0, 0.3, 0.5, 0.9, 1.0], np.float32), (N, h, w))
    slot = rng.choice(np.array([-1, 0, N // 2, N - 1, 3]), (h, w))
    yy, xx = np.mgrid[0:h, 0:w]
    P[np.maximum(slot, 0), yy, xx] = np.where(slot >= 0, np.maximum(P[np.maximum(slot, 0), yy, xx], 0.02),
                                              P[np.maximum(slot, 0), yy, xx])
    key = keys[np.maximum(slot, 0), :, yy, xx].transpose(2, 0, 1).copy()
    key[0] = np.where(slot >= 0, key[0], 63)
    # a second matching entry after the first, and a matching key on an
    # unused entry before it
    dup = (rng.random((h, w)) < 0.2) & (slot >= 0) & (slot < N - 1)
    later = np.minimum(slot + 1 + rng.integers(0, 4, (h, w)), N - 1)
    dead = (rng.random((h, w)) < 0.2) & (slot > 0) & ~dup
    for mask, where, p_set in ((dup, later, None), (dead, slot - 1, 0.0)):
        ys, xs = np.nonzero(mask)
        keys[where[ys, xs], :, ys, xs] = key[:, ys, xs].T
        if p_set is not None:
            P[where[ys, xs], ys, xs] = p_set
            Pb[where[ys, xs], ys, xs] = p_set
    return keys, P.astype(dtype), Pb.astype(dtype), key


def _inputs(seed, h, w, dtype, first):
    rng = np.random.default_rng(seed)
    st = {}
    ct_key, ct_P, ct_Pb, ckey = _table(rng, CFG.N2c, 3, h, w, dtype)
    cc_key, cc_P, cc_Pb, cckey = _table(rng, CFG.N2cc, 6, h, w, dtype)
    st.update(ct_key=ct_key, ct_P=ct_P, ct_Pb=ct_Pb, cc_key=cc_key, cc_P=cc_P, cc_Pb=cc_Pb)
    st["fg_age"] = rng.choice(np.array([0, 3, 29, 29, 30, 41], np.int32), (h, w))
    changed = rng.random((h, w)) < 0.5
    return st, ckey, cckey, changed, np.bool_(first)


def _cases_occurred(st, ckey, cckey, changed, lab_bg, is_bg):
    """Assert that every listed case occurred on these inputs."""
    tables = (("ct", ckey, CFG.N1c, ~changed), ("cc", cckey, CFG.N1cc, changed))
    for prefix, key, n1, consult in tables:
        keys, P = st[f"{prefix}_key"], st[f"{prefix}_P"].astype(np.float32)
        N = P.shape[0]
        eq = (keys == key[None]).all(axis=1)
        match = eq & (P > 0)
        n_match = match.sum(axis=0)
        fi = np.where(match.any(0), match.argmax(0), -1)
        assert (consult & (fi < 0)).any(), f"{prefix}: no match"
        for at in (0, N // 2, N - 1):
            assert (consult & (fi == at)).any(), f"{prefix}: match at entry {at}"
        assert (consult & (n_match >= 2)).any(), f"{prefix}: two matching entries"
        assert (consult & (eq & (P == 0)).any(0) & (fi >= 0)).any(), f"{prefix}: matching key on an unused entry"
        P_m = np.take_along_axis(P, np.maximum(fi, 0)[None], 0)[0]
        ties = ((P == P_m[None]) & (np.arange(N)[:, None, None] < fi[None])).any(0)
        assert (consult & (fi >= 0) & ties).any(), f"{prefix}: rank tie at the match"
        rank = (P > P_m[None]).sum(0)
        assert (consult & (fi >= 0) & (rank >= n1)).any(), f"{prefix}: a match outside the top N1"
        n_min = (P == P.min(axis=0, keepdims=True)).sum(0)
        full = (P > 0).all(axis=0)
        assert (consult & (fi < 0) & full & (n_min >= 2)).any(), f"{prefix}: a full table replaced at a tied least P"
        assert (consult & (P == 0).any(0)).any(), f"{prefix}: unused entries"
    absorbed = (st["fg_age"] == 29) & ~is_bg
    assert absorbed.any() and lab_bg[absorbed].all(), "fg_age 29 -> 30 absorbed"
    assert (~is_bg).any() and is_bg.any()


@pytest.mark.parametrize(
    "h,w,dtype,first",
    [(24, 40, np.float16, False), (26, 70, np.float16, False), (24, 40, np.float32, False),
     (26, 70, np.float32, False), (24, 40, np.float16, True)],
)
def test_fgd_tables_ref_matches_pallas(h, w, dtype, first):
    st, ckey, cckey, changed, f = _inputs(h * w + int(first), h, w, dtype, first)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    jargs = (jnp.asarray(ckey), jnp.asarray(cckey), jnp.asarray(changed), jnp.asarray(f))
    want = fgd_tables_pallas(JF._tables_phase, CFG, jst, *jargs, interpret=True)
    xla = JF._tables_phase(CFG, jst, *jargs)
    got = fgd_tables(CFG, to_torch(st), *(torch.from_numpy(np.array(a)) for a in (ckey, cckey, changed, f)))
    for ref, name in ((want, "pallas"), (xla, "xla")):
        assert_tree_equal({k: np.asarray(ref[0][k]) for k in TABLE_LEAVES}, got[0], name)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]), err_msg=f"{name} is_bg")
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]), err_msg=f"{name} lab_bg")
    assert got[0]["ct_P"].dtype == (torch.float16 if dtype == np.float16 else torch.float32)
    if first:
        assert bool(got[1].all())
    else:
        _cases_occurred(st, ckey, cckey, changed, got[2].numpy(), got[1].numpy())
