"""The FG_0 path in the port against the JAX package.

- FGD with the JAX package's kernel branch (``TRACKING_TPU_FGD=interp``:
  ``fgd_tables_pallas`` in interpret mode) against the port's step through
  ``ops.fgd.fgd_tables``, on fresh instances, counting the calls of both so
  each package provably took its branch; masks, bg images and every state
  leaf exact, on the noisy clip at 26×70 (which the TPU kernel pads).
- FGD → the default CCMSPF ``BlobTracker`` (BD_CC), the tracking app's
  ``--fg FG_0`` with the default tracker, on the quiet clip: masks exact
  every frame, track tables bit for bit (Kalman floats included),
  a track confirmed from FGD's masks (the port's FGD comes from the
  registry as ``get_algorithm("FG_0")``).
- ``area_gate`` (FGD's minArea gate) against JAX's CPU branch: specks
  below ``minArea``, more than 64 components clearing it, equal areas at
  the 64th place; 8- and 4-connected, exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracking_tpu.ops.pallas_fgd as JPF
from torch_parity import count_calls, run_both, step_both
from tracking_tpu.bgs import fgd as JF
from tracking_tpu.ops.cc import area_gate as j_area_gate
from tracking_tpu.runner.scan import run_video as jrun
from tracking_tpu.track.tracker import BlobTracker as JTracker
from tracking_tpu_torch import get_algorithm
from tracking_tpu_torch.bgs import fgd as TF
from tracking_tpu_torch.ops.cc import area_gate
from tracking_tpu_torch.synth import make_clip
from tracking_tpu_torch.track.tracker import BlobTracker as TTracker


def test_fgd_matches_the_reference_kernel_branch(monkeypatch):
    monkeypatch.setenv("TRACKING_TPU_FGD", "interp")
    j_calls = count_calls(monkeypatch, JPF, "fgd_tables_pallas")
    t_calls = count_calls(monkeypatch, TF, "fgd_tables")
    frames = make_clip(6, 26, 70, 3, seed=9)
    shares, ts = run_both(JF.FGD(), TF.FGD(), frames)
    assert len(j_calls) >= 1 and len(t_calls) == frames.shape[0] - 1  # both packages took the kernel branch
    assert int((ts["cc_P"] > 0).sum()) > 0 and 0.0 < np.mean(shares) <= 1.0


def test_fg0_then_tracker():
    h, w = 48, 64
    frames = make_clip(16, h, w, 3, seed=11, n_objects=2, noise=0.5)
    ta, ja = get_algorithm("FG_0")(), JF.FGD()
    jb = jax.jit(ja.warm_start)(ja.init(h, w, 3), jnp.asarray(frames[0]))
    tb = ta.warm_start(ta.init(h, w, 3, device="cpu"), torch.from_numpy(frames[0]))
    jt, tt = JTracker(), TTracker()
    js, ts = jt.init(), tt.init(device="cpu")
    jstep = jax.jit(jt.step)
    shares = []
    for t in range(1, frames.shape[0]):
        jb, jm = jrun(ja, jnp.asarray(frames[t : t + 1]), state=jb)
        tb, fg, _ = ta.step(tb, torch.from_numpy(frames[t]))
        np.testing.assert_array_equal(fg.numpy(), np.asarray(jm[0]), err_msg=f"mask, frame {t}")
        js, ts, _ = step_both(jstep, tt, js, ts, np.asarray(jm[0]))
        shares.append(float((fg.numpy() > 0).mean()))
    assert 0.01 < np.mean(shares) < 0.5, shares
    assert int(ts["next_id"]) >= 1 and bool(ts["active"].any())  # tracks confirmed from FGD's masks


def _gate_masks(seed, h, w):
    """0/255 masks: specks of 1-14 px beside blobs that clear minArea = 15,
    80 components of 16 px (more than 64 clear it, all tied at the 64th
    place), and 70 of mixed sizes with ties at the 64th place."""
    rng = np.random.default_rng(seed)
    specks = np.zeros((h, w), np.uint8)
    specks[(rng.random((h, w)) < 0.04)] = 255
    specks[10:20, 10:30] = 255
    specks[40:46, 50:53] = 255  # 18 px
    specks[60:63, 70:75] = 255  # exactly 15 px
    grid = np.zeros((h, w), np.uint8)
    for i in range(80):
        y, x = 6 * (i // 16), 6 * (i % 16)
        grid[y : y + 4, x : x + 4] = 255
    mixed = np.zeros((h, w), np.uint8)
    sizes = [5] * 10 + [4] * 60  # side lengths: 25 and 16 px, 16 px tied around the 64th
    for i, s in enumerate(sizes):
        y, x = 7 * (i // 14), 7 * (i % 14)
        mixed[y : y + s, x : x + s] = 255
    return {"specks": specks, "grid80": grid, "mixed_ties": mixed}


@pytest.mark.parametrize("connectivity", [8, 4])
def test_area_gate_matches_reference(connectivity):
    masks = _gate_masks(2, 72, 100)
    for name, m in masks.items():
        want = np.asarray(j_area_gate(jnp.asarray(m), 15.0, max_blobs=64, connectivity=connectivity))
        got = area_gate(torch.from_numpy(m), 15.0, max_blobs=64, connectivity=connectivity)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name}, {connectivity}-connected")
        if name != "specks":
            assert 0 < (want > 0).sum() < (m > 0).sum(), name  # the 64 cap dropped some
    kept = np.asarray(j_area_gate(jnp.asarray(masks["specks"]), 15.0, connectivity=connectivity)) > 0
    assert kept[60:63, 70:75].all() and not kept[masks["specks"] > 0].all()
