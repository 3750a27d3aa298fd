"""subsenseShrink in the port against the JAX package.

- ``_rgb2lab_u8`` over all 2^24 colours. XLA:CPU folds the reference's
  constant chains (the port multiplies by the same folded constants) and
  calls the C library's ``powf`` for ``**`` and ``cbrt`` (``pow(|t|, 1/3)``);
  the port takes those powers in float64 and rounds once. The stated
  tolerance: at most 1 Lab level on at most 8 colours (measured: 3 colours,
  all by one level in one channel, from cube roots where the C library's
  ``powf`` is not correctly rounded). The test prints the residue.
- Whole runs through both packages' ``run_video`` at 48×64×3, long enough
  that the overlay raises the requirement (``yzbx_t > 5``): with the split
  v1 step, and with ``TRACKING_TPU_FUSED=1`` (the JAX package with
  ``TRACKING_TPU_FUSED_INTERP=1``). Every state leaf bit-exact after every
  frame. The clip's colours avoid the Lab residue (checked, and printed), so
  no tolerance is needed there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracking_tpu.ops.pallas_consensus as JPC
from torch_parity import count_calls, run_both
from tracking_tpu.bgs import subsense_shrink as JS
from tracking_tpu_torch.bgs import lbsp_family as TLF
from tracking_tpu_torch.bgs import subsense_shrink as TS
from tracking_tpu_torch.synth import make_clip

LAB_TOL_COLOURS = 8


def _lab_residue(img, jlab):
    want = np.asarray(jlab(jnp.asarray(img)))
    got = TS._rgb2lab_u8(torch.from_numpy(img)).numpy()
    diff = np.abs(got.astype(np.int32) - want)
    return diff, img[diff.any(-1)]


def test_rgb2lab_all_colours():
    jlab = jax.jit(JS._rgb2lab_u8)
    allc = np.arange(1 << 24, dtype=np.int64)
    img = np.stack([(allc >> 16) & 255, (allc >> 8) & 255, allc & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    worst, bad = 0, []
    for i in range(0, 4096, 1024):
        diff, colours = _lab_residue(img[i : i + 1024], jlab)
        worst = max(worst, int(diff.max()))
        bad.extend(colours.tolist())
    print(f"Lab residue: {len(bad)} of {1 << 24} colours differ, by at most {worst}: {bad}")
    assert worst <= 1 and len(bad) <= LAB_TOL_COLOURS


@pytest.mark.parametrize("fused", [False, True], ids=["v1", "fused"])
def test_subsense_shrink_matches_reference(monkeypatch, fused):
    for var in ("TRACKING_TPU_CONSENSUS", "TRACKING_TPU_FUSED", "TRACKING_TPU_FUSED_INTERP"):
        monkeypatch.delenv(var, raising=False)
    if fused:
        monkeypatch.setenv("TRACKING_TPU_FUSED", "1")
        monkeypatch.setenv("TRACKING_TPU_FUSED_INTERP", "1")
    jax_fused = count_calls(monkeypatch, JPC, "consensus_feedback_pallas")
    port_fused = count_calls(monkeypatch, TLF, "consensus_feedback")
    offset_px = []
    step = TLF.SuBSENSE.step

    def recording_step(self, state, frame, use_kernels=True):
        offset_px.append(int(state["shrink_req_offset"].gt(0).sum()))
        return step(self, state, frame, use_kernels=use_kernels)

    monkeypatch.setattr(TLF.SuBSENSE, "step", recording_step)

    frames = make_clip(10, 48, 64, 3, seed=2, n_objects=5)
    diff, _ = _lab_residue(frames, jax.jit(JS._rgb2lab_u8))
    print(f"Lab residue on the clip: {int(diff.any(-1).sum())} px")
    assert not diff.any()
    shares, ts = run_both(JS.SuBSENSEShrink(), TS.SuBSENSEShrink(), frames)
    print(f"fused={fused}: pixels with the raised requirement per frame {offset_px}")
    assert int(ts["yzbx_t"]) == 9 and sum(offset_px[6:]) > 0  # the requirement map fired
    assert sum(offset_px[:6]) == 0
    assert 0.0 < np.mean(shares) < 0.5, shares
    if fused:
        assert len(jax_fused) >= 1 and len(port_fused) == 9
    else:
        assert not jax_fused and not port_fused
