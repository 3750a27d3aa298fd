"""The invariant that FGD's table kernel relies on, held on its plain version
and on the JAX package's table phase.

``csrc/fgd.cu`` skips reading a Pb word where no pixel of its quad has
P > 0, and stores only the words that change. Both are exact only if, in
every state the algorithm reaches, Pb <= P entrywise (so P = 0 implies
Pb = 0), and if a pixel's unconsulted table is left as it was. This file
runs ``fgd_tables_ref`` (the plain version: the wrapper on CPU tensors)
through FGD steps of seeded synthetic clips (noise 0.5, the quiet clip the
FG_0 path runs, and 2.5, where most pixels change), with f16 and f32
statistics at 48x64, and asserts after every step:

- Pb <= P entrywise and P = 0 implies Pb = 0, in both tables;
- the co-occurrence table is unchanged where a pixel did not change, and
  the colour table where it changed (after the first frame);

and holds the last step against ``bgs/fgd.py:_tables_phase`` on the same
numpy inputs, so the invariant stands on the reference's states too. A
last case fills the unused entries with f16 subnormal P values, most of
which the decay by 1 - alpha2 rounds back to themselves: the plain version
leaves those bit-equal, as the kernel (which stores only changed words)
does, and agrees with ``_tables_phase`` there.
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal
from tracking_tpu.bgs import fgd as JF
from tracking_tpu_torch import get_algorithm
from tracking_tpu_torch.bgs import fgd as BF
from tracking_tpu_torch.ops.fgd import TABLE_LEAVES
from tracking_tpu_torch.synth import make_clip

H, W, FRAMES = 48, 64, 10
_JTABLES = jax.jit(JF._tables_phase, static_argnums=0)


def _steps(noise, stat_dtype, monkeypatch):
    """[(args, out)] of every table phase of an FGD run on the clip: args
    (cfg, state, ckey, cckey, changed, first) as the step passes them."""
    monkeypatch.setattr(BF.FGD, "STAT_DTYPE", stat_dtype)
    calls = []
    orig = BF.fgd_tables

    def spy(cfg, state, *rest):
        before = {k: state[k].clone() for k in TABLE_LEAVES}
        out = orig(cfg, state, *rest)
        calls.append(((cfg, before, *rest), out))
        return out

    monkeypatch.setattr(BF, "fgd_tables", spy)
    algo = get_algorithm("FG_0")()
    frames = torch.from_numpy(make_clip(FRAMES, H, W, 3, seed=3, noise=noise))
    st = algo.init(H, W, 3, device="cpu")
    for t in range(FRAMES):
        st, _, _ = algo.step(st, frames[t])
    return calls


def _assert_invariant(tables, what):
    for prefix in ("ct", "cc"):
        P, Pb = tables[f"{prefix}_P"].to(torch.float32), tables[f"{prefix}_Pb"].to(torch.float32)
        assert bool((Pb <= P).all()), f"{what}: {prefix} Pb > P"
        assert not bool(((P == 0) & (Pb != 0)).any()), f"{what}: {prefix} P = 0 with Pb != 0"


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.float16 else t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_matches_reference(args, out, what):
    cfg, st, ckey, cckey, changed, first = args
    want = _JTABLES(cfg, {k: v.numpy() for k, v in st.items()}, ckey.numpy(), cckey.numpy(), changed.numpy(),
                    first.numpy())
    assert_tree_equal({k: np.asarray(want[0][k]) for k in TABLE_LEAVES}, {k: out[0][k] for k in TABLE_LEAVES}, what)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(want[1]), err_msg=f"{what} is_bg")
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(want[2]), err_msg=f"{what} lab_bg")


@pytest.mark.parametrize("stat_dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("noise", [0.5, 2.5])
def test_fgd_tables_keep_pb_below_p(noise, stat_dtype, monkeypatch):
    calls = _steps(noise, stat_dtype, monkeypatch)
    assert len(calls) == FRAMES
    for t, ((cfg, st, ckey, cckey, changed, first), (upd, is_bg, lab_bg)) in enumerate(calls):
        _assert_invariant(st, f"frame {t} in")
        _assert_invariant(upd, f"frame {t} out")
        for prefix, kept in (("cc", ~changed), ("ct", changed & ~first)):
            for leaf in ("key", "P", "Pb"):
                a, b = _bits(st[f"{prefix}_{leaf}"]), _bits(upd[f"{prefix}_{leaf}"])
                m = kept.expand_as(a)
                assert torch.equal(a[m], b[m]), f"frame {t}: {prefix}_{leaf} changed where it is not consulted"
    changed = torch.stack([c[0][4] for c in calls[1:]]).to(torch.float32).mean()
    assert 0.0 < float(changed) < 1.0, "both tables consulted"
    used = sum(int((calls[-1][1][0][f"{p}_P"] > 0).sum()) for p in ("ct", "cc"))
    assert used > H * W, "tables in use"
    _assert_matches_reference(*calls[-1], f"noise {noise}, {stat_dtype}, frame {FRAMES - 1}")


def test_fgd_tables_leave_decayed_subnormals_bit_equal(monkeypatch):
    args, _ = _steps(0.5, torch.float16, monkeypatch)[6]
    cfg, st, ckey, cckey, changed, first = args
    st = {k: v.clone() for k, v in st.items()}
    gen = torch.Generator().manual_seed(5)
    for prefix in ("ct", "cc"):
        P, Pb = st[f"{prefix}_P"], st[f"{prefix}_Pb"]
        k = torch.randint(1, 200, P.shape, generator=gen, dtype=torch.int32)  # P = k * 2^-24, subnormal in f16
        sub = (k.to(torch.float32) * 2.0**-24).to(torch.float16)
        seen_bg = torch.rand(P.shape, generator=gen) < 0.5
        Pb.copy_(torch.where(P == 0, torch.where(seen_bg, sub, torch.zeros_like(sub)), Pb))
        P.copy_(torch.where(P == 0, sub, P))
    _assert_invariant(st, "subnormal state")
    upd, is_bg, lab_bg = BF.fgd_tables(cfg, st, ckey, cckey, changed, first)
    _assert_invariant(upd, "after the step")
    for prefix, consult in (("ct", ~changed | first), ("cc", changed)):
        P0, P1 = _bits(st[f"{prefix}_P"]), _bits(upd[f"{prefix}_P"])
        # k < 100: 0.005 k is below half a unit, so the product rounds back
        fixed = (P0 > 0) & (P0 < 100) & consult[None]
        same = (P1 == P0) & fixed
        # each consulted pixel updates one entry; every other such entry stays bit-equal
        assert bool(((fixed & ~same).sum(0) <= 1).all()), f"{prefix}: a decayed subnormal moved"
        assert int(same.sum()) > int(consult.sum()), f"{prefix}: subnormal entries kept"
        moved = (P0 > 100) & (P0 < 0x400) & consult[None]  # larger subnormals decay by a unit or more
        assert bool((P1[moved] < P0[moved]).any())
    _assert_matches_reference((cfg, st, ckey, cckey, changed, first), (upd, is_bg, lab_bg), "subnormal entries")
