"""MultiLayer's update on states the clips rarely reach, and the invariant
the CUDA kernel (``csrc/multilayer.cu``) relies on to skip tail modes.

- ``multilayer_step`` (plain, on CPU tensors) against
  ``multilayer_step_pallas`` in interpret mode at 24×40 on
  ``synth.multilayer_adversarial`` states (n uniform in 0..5, live modes
  weight-sorted, random words in the tail) that fire every branch of the
  update: removal (and removal emptying a list), match with promotion,
  displacement, no-match append, no-match overwrite at n = 5, the empty
  seed; learning and not. Every leaf and the distance bit for bit (the
  colour distance takes XLA:CPU's ``exp`` and ``sqrt``,
  ``ops/xla_math``), also on the pixels whose distances lie within
  ``TIE`` of a tie or of the match threshold where one of them came
  through ``exp`` (counted and printed; an exact tie of two out-of-range
  modes, whose colour distances are both 1, is no such pixel).
- The tail-mode invariant, through ``ml_update_ref`` on random states: on
  a pixel with no removal and no displacement every word of every slot
  m >= n on entry comes out unchanged, except the slot a no-match or an
  empty pixel's seed writes (and that seed leaves ``layer_time`` of slot 0
  as it was); with a displacement and no removal only the tail's
  ``bg_layer`` words change. The kernel reads a tail mode only on pixels
  with a removal (all its words) or a displacement (its layer), and writes
  only words that change.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_multilayer import TIE
from tracking_tpu.bgs import multilayer as JM
from tracking_tpu.ops.pallas_multilayer import multilayer_step_pallas
from tracking_tpu_torch.bgs.multilayer import MultiLayerConfig
from tracking_tpu_torch.ops import xla_math
from tracking_tpu_torch.ops.multilayer import INF, LEAF_SPEC, joint_distances, multilayer_step, update_branches
from tracking_tpu_torch.synth import multilayer_adversarial

M = 5
LR, WLR, IMW, FIDX = 0.05, 0.05, 0.05, 60


def _inputs(h, w, seed):
    st, cf, pat = multilayer_adversarial(h, w, seed)
    ts = {k: torch.from_numpy(v) for k, v in st.items()}
    scal = torch.tensor([LR, WLR, IMW, 1 - LR], dtype=torch.float32)
    return st, ts, torch.from_numpy(cf), torch.from_numpy(pat), scal


def _near_a_tie(cfg, ts, cf, pat, removal, monkeypatch):
    """Pixels whose two smallest distances after the removal, or whose best
    distance and the match threshold, lie within TIE where one of them came
    through ``exp`` (a colour distance other than 0 or 1)."""
    A = {short: list(ts[leaf].unbind(0)) for leaf, short in LEAF_SPEC}
    n = ts["n"]
    joints = joint_distances(cfg, A, n, cf, pat)
    with monkeypatch.context() as mp:  # NaN wherever exp takes a nonzero argument
        exp = xla_math.exp
        mp.setattr(xla_math, "exp", lambda x: torch.where(x == 0, exp(x), torch.nan))
        via_exp = torch.stack(joint_distances(cfg, A, n, cf, pat)).isnan()
    # the removal drops the first faded layered live mode
    r = torch.full(n.shape, M)
    for m in reversed(range(M)):
        r = torch.where((ts["bg_layer"][m] > 0) & (ts["weight"][m] < cfg.min_bg_layer_weight) & (n > m), m, r)
    d = torch.stack([torch.where(removal & (r == m), INF, j) for m, j in enumerate(joints)])
    srt, order = d.sort(dim=0, stable=True)
    e1, e2 = via_exp.gather(0, order[:1])[0], via_exp.gather(0, order[1:2])[0]
    return (((srt[1] - srt[0]).abs() < TIE) & (e1 | e2)) | (
        ((srt[0] - cfg.bg_prob_updating_threshold).abs() < TIE) & e1)


@pytest.mark.parametrize("learn", [True, False], ids=["learn", "frozen"])
def test_adversarial_update_matches_reference_kernel(learn, monkeypatch):
    h, w = 24, 40
    st, ts, cf, pat, scal = _inputs(h, w, seed=3)
    cfg = MultiLayerConfig()
    js = {k: jnp.asarray(v) for k, v in st.items()}
    maps, dist = multilayer_step_pallas(JM._ml_update, JM.MultiLayerBGS().config, js, jnp.asarray(cf.numpy()),
                                        jnp.asarray(pat.numpy()), LR, WLR, IMW, jnp.int32(FIDX), learn,
                                        interpret=True)
    got, tdist = multilayer_step(cfg, {k: v.clone() for k, v in ts.items()}, cf, pat, scal,
                                 torch.tensor(FIDX, dtype=torch.int32), learn)
    branches = update_branches(cfg, ts, cf, pat, scal, got["n"], learn)
    near = _near_a_tie(cfg, ts, cf, pat, branches["removal"], monkeypatch)
    counts = {k: int(v.sum()) for k, v in branches.items()}
    print(f"learn={learn}: pixels a branch {counts}; {int(near.sum())} px near a tie")
    for k, c in counts.items():
        if learn or k == "empty":
            assert c > 0, (k, counts)
    for k, ref in maps.items():
        ref, g = np.asarray(ref), got[k].numpy()
        assert g.dtype == ref.dtype and g.shape == ref.shape, k
        np.testing.assert_array_equal(g, ref, err_msg=k)
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(dist))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_keeps_tail_modes(seed):
    h, w = 48, 64
    _, ts, cf, pat, scal = _inputs(h, w, seed)
    cfg = MultiLayerConfig()
    got, _ = multilayer_step(cfg, {k: v.clone() for k, v in ts.items()}, cf, pat, scal,
                             torch.tensor(FIDX, dtype=torch.int32), True)
    n_in, n_out = ts["n"], got["n"]
    br = update_branches(cfg, ts, cf, pat, scal, n_out, True)
    removal, displaced = br["removal"], br["displacement"]
    seeded = br["append"] | br["empty"]
    slot = torch.arange(M)[:, None, None]
    tail = slot >= n_in[None]
    plain = tail & ~(removal | displaced)[None] & ~(seeded[None] & (slot == n_in[None]))
    moved = {}
    for leaf, _ in LEAF_SPEC:
        a, b = ts[leaf], got[leaf]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        changed = a != b
        if changed.ndim == 4:  # a feature axis under the mode axis
            changed = changed.any(dim=1)
        moved[leaf] = int((changed & plain).sum())
        if leaf != "bg_layer":
            moved[leaf] += int((changed & tail & displaced[None]).sum())
    empty = br["empty"]
    moved["layer_time of an empty pixel's seed"] = int((ts["layer_time"][0] != got["layer_time"][0])[empty].sum())
    counts = {"removal": int(removal.sum()), "displacement": int(displaced.sum()), "seed": int(seeded.sum()),
              "tail words held": int(plain.sum())}
    print(f"seed {seed}: {counts}; changed tail words {moved}")
    assert counts["removal"] > 0 and counts["displacement"] > 0 and counts["seed"] > 0 and int(empty.sum()) > 0
    assert not any(moved.values()), moved
    # the renumbering does reach the tail's layers
    renum = (ts["bg_layer"] != got["bg_layer"]) & tail & displaced[None]
    print(f"seed {seed}: tail layers renumbered by a displacement {int(renum.sum())}")
