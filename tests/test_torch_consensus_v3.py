"""Consensus v3 in the port against the JAX package (``TRACKING_TPU_CONSENSUS=v3``).

- The read-only walk: the port's plain ``consensus_read_ref`` (through the
  wrapper ``consensus_read`` on CPU tensors) against both TPU kernels it
  stands for, in interpret mode: ``pallas_consensus.consensus_read_pallas``
  and the retired v2 walk ``attic/pallas_consensus2.py:consensus_walk_pallas``
  (loaded by file path, as the attic is no package). Half the image is near
  background so its walks stop early.
- The eager bank update with frame-global slots, ``_apply_updates_global``,
  with a deliberate slot collision; the carried ``bg_sum`` must equal the
  bank's sum.
- SuBSENSE v3 frame by frame on every state leaf: 48×64 colour and grey,
  and the v3 refresh branch from a mid-stream 288×544 state.

Every comparison is bit-exact. ``_use_v2`` is read by ``init``: each case
sets the variable with monkeypatch, builds fresh algorithm instances (so no
JAX trace of another branch is reused) and checks that both packages took
the v3 branch (``bg_sum`` in the states; the port's walk counted).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal, count_calls, run_both, to_torch
from tracking_tpu.bgs import lbsp_family as LF
from tracking_tpu.ops.pallas_consensus import consensus_read_pallas
from tracking_tpu.ops.pallas_consensus import nb3_to_nb5_idx as j_nb3_to_nb5_idx
from tracking_tpu.ops.pallas_consensus import pack_pending_vals as j_pack_pending_vals
from tracking_tpu_torch.bgs import lbsp_family as TLF
from tracking_tpu_torch.ops import consensus as tc
from tracking_tpu_torch.synth import make_clip

MIN_CD, DESC_OFF, REL = 30, 3, 0.333
ATTIC = Path(__file__).resolve().parents[1] / "attic" / "pallas_consensus2.py"


def _attic_walk():
    spec = importlib.util.spec_from_file_location("attic_pallas_consensus2", ATTIC)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.consensus_walk_pallas


@pytest.mark.parametrize("C", [1, 3])
def test_read_walk_matches_both_tpu_kernels(C):
    rng = np.random.default_rng(11 + C)
    H, W, N = 24, 40, 20
    planes = tuple(rng.integers(0, 256, (H, W), np.uint8) for _ in range(C))
    colors = [rng.integers(0, 256, (N, H, W), np.uint8) for _ in range(C)]
    descs = [rng.integers(0, 1 << 16, (N, H, W)).astype(np.uint16) for _ in range(C)]
    delta = 2
    div = 3.0 if C == 1 else 1.0
    hi = float(np.rint(255 * REL))
    intra, _ = LF._intra_descriptor(tuple(map(jnp.asarray, planes)), LF.SuBSENSE()._thr_fn(C, jnp.int32(delta)))
    for c in range(C):  # the top half near background: those walks stop early
        colors[c][:, : H // 2] = planes[c][None, : H // 2]
        descs[c][: N // 2, : H // 2] = np.asarray(intra[c])[None, : H // 2]
    colors, descs = tuple(colors), tuple(descs)
    R = rng.uniform(1.0, 6.0, (H, W)).astype(np.float32)
    unstable = rng.integers(0, 2, (H, W)).astype(bool)
    required = np.where(rng.uniform(size=(H, W)) < 0.1, 0, 2).astype(np.int32)

    got = tc.consensus_read(
        to_torch(planes), to_torch(colors), to_torch(descs), torch.tensor(delta, dtype=torch.int32),
        torch.from_numpy(R), torch.from_numpy(unstable), torch.from_numpy(required),
        rel=REL, div=div, hi_const=hi, min_cd=MIN_CD, desc_off=DESC_OFF,
    )
    J = lambda t: tuple(map(jnp.asarray, t))  # noqa: E731
    kw = dict(required=jnp.asarray(required), rel=REL, div=div, hi_const=hi, min_cd=MIN_CD, desc_off=DESC_OFF,
              interpret=True)
    args = (J(planes), J(colors), J(descs), jnp.int32(delta), jnp.asarray(R), jnp.asarray(unstable.astype(np.int32)))
    for name, walk in (("consensus_read_pallas", consensus_read_pallas), ("attic consensus_walk_pallas", _attic_walk())):
        want = walk(*args, **kw)
        assert_tree_equal(tuple(jax.tree.map(np.asarray, tuple(want))), tuple(got), name)
    count = got[0].numpy()
    assert (count[: H // 2] == required[: H // 2]).mean() > 0.9  # converged early
    assert ((count < required) & (required > 0)).any()  # and walked to the end elsewhere


@pytest.mark.parametrize("C", [1, 3])
def test_apply_updates_global_matches_reference(C):
    rng = np.random.default_rng(5 + C)
    H, W, N = 12, 18, 10
    colors = tuple(rng.integers(0, 256, (N, H, W), np.uint8) for _ in range(C))
    descs = tuple(rng.integers(0, 1 << 16, (N, H, W)).astype(np.uint16) for _ in range(C))
    planes = tuple(rng.integers(0, 256, (H, W), np.uint8) for _ in range(C))
    intras = tuple(rng.integers(0, 1 << 16, (H, W)).astype(np.uint16) for _ in range(C))
    fires = (rng.integers(0, 2, (H, W)) | (rng.integers(0, 2, (H, W)) << 1)).astype(np.uint8)
    upd1 = rng.integers(0, 2, (H, W)).astype(bool)
    o3 = rng.integers(0, 8, (H, W)).astype(np.int32)
    o5 = rng.integers(0, 24, (H, W)).astype(np.int32)
    s1, s3, s5 = 4, 7, 4  # deliberate s1 == s5 collision
    bg0 = tuple(c.astype(np.int32).sum(0, dtype=np.int32) for c in colors)

    J = lambda t: tuple(map(jnp.asarray, t))  # noqa: E731
    jvals = j_pack_pending_vals(J(planes), J(intras), jnp.asarray(fires))
    want = jax.jit(LF._apply_updates_global)(
        jnp.asarray(upd1), j_nb3_to_nb5_idx(jnp.asarray(o3)), jnp.asarray(o5), jnp.int32(s1), jnp.int32(s3),
        jnp.int32(s5), jvals, J(colors), J(descs), J(bg0),
    )
    tvals = tc.pack_pending_vals(to_torch(planes), to_torch(intras), torch.from_numpy(fires))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    got = TLF._apply_updates_global(
        torch.from_numpy(upd1), tc.nb3_to_nb5_idx(torch.from_numpy(o3)), torch.from_numpy(o5), i32(s1), i32(s3),
        i32(s5), tvals, to_torch(colors), to_torch(descs), to_torch(bg0),
    )
    assert_tree_equal(jax.tree.map(np.asarray, tuple(want)), got)
    for c in range(C):
        np.testing.assert_array_equal(got[0][c].to(torch.int32).sum(0).numpy(), got[2][c].numpy())
        assert (got[0][c].numpy() != colors[c]).any()  # slots were written


def _check_v3_branch(monkeypatch):
    monkeypatch.setenv("TRACKING_TPU_CONSENSUS", "v3")
    return count_calls(monkeypatch, TLF, "consensus_read")


@pytest.mark.parametrize("c,frames_n", [(3, 6), (1, 5)], ids=["color-48x64", "gray-48x64"])
def test_subsense_v3_matches_reference(monkeypatch, c, frames_n):
    walks = _check_v3_branch(monkeypatch)
    frames = make_clip(frames_n, 48, 64, c, seed=c + 20)
    ja, ta = LF.SuBSENSE(), TLF.SuBSENSE()
    assert "bg_sum" in ja.init(48, 64, c) and "pend_ctrl" not in ta.init(48, 64, c, device="cpu")
    shares, ts = run_both(ja, ta, frames)
    assert "bg_sum" in ts and len(walks) == frames_n - 1
    assert 0.0 < np.mean(shares) < 0.5, shares
    for ci in range(c):
        np.testing.assert_array_equal(ts["colors"][ci].to(torch.int32).sum(0).numpy(), ts["bg_sum"][ci].numpy())


def test_subsense_v3_refresh_branch(monkeypatch):
    """The v3 auto-reset refresh at 288×544×3 (scaling branch), from the
    mid-stream state of test_torch_subsense_scaling.py: frame 1 triggers it
    and the carried bank sum is recomputed."""
    walks = _check_v3_branch(monkeypatch)
    h, w = 288, 544
    frames = make_clip(3, h, w, 3, seed=5)
    ja = LF.SuBSENSE()
    js = jax.jit(ja.warm_start)(ja.init(h, w, 3), jnp.asarray(frames[0]))
    assert "bg_sum" in js
    js = dict(js, t=jnp.int32(100), ds_lt=tuple(jnp.zeros_like(d) for d in js["ds_lt"]),
              ds_st=tuple(jnp.full_like(d, 120.0) for d in js["ds_st"]))
    shares, ts = run_both(ja, TLF.SuBSENSE(), frames, jstate=js)
    assert int(ts["cooldown"]) == 25 - 2  # frame 1 triggered the refresh
    assert len(walks) == 2 and max(shares) > 0.0
    for ci in range(3):
        np.testing.assert_array_equal(ts["colors"][ci].to(torch.int32).sum(0).numpy(), ts["bg_sum"][ci].numpy())


def test_consensus_v2_raises(monkeypatch):
    monkeypatch.setenv("TRACKING_TPU_CONSENSUS", "v2")
    with pytest.raises(RuntimeError, match="attic"):
        TLF.SuBSENSE().init(8, 8, 3, device="cpu")
