"""MultiLayerBGS (type 23) and its helpers in the port against the JAX
package.

- One update step: the port's plain ``ml_update_ref`` (via
  ``multilayer_step`` on CPU tensors) and the reference's ``_ml_update``
  (via ``multilayer_step_pallas`` in interpret mode) from the same
  mid-stream state, learning and not.
- Whole runs through both packages' ``run_video``, with the default
  LEARN status and with ``detectAfter`` flipping the rates on frame 3.
- The helpers it uses: ``gaussian_blur``, ``bgr2gray_u8`` and the sorting
  network, exactly.

No tolerance: the port's colour distance takes XLA:CPU's ``exp`` and
``sqrt`` (``ops/xla_math``), so the masks, ``n``, the bg image and every
state leaf equal the JAX package's bit for bit, also on pixels whose two
best modes, or whose best distance and the 0.2 match threshold, lie within
``TIE`` of each other (where an ulp of ``exp`` would pick another branch;
each test prints how many there were).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_step_equal, run_both
from tracking_tpu.bgs import gmm as JGMM
from tracking_tpu.bgs import multilayer as JM
from tracking_tpu.ops import color as JC
from tracking_tpu.ops import filters as JF
from tracking_tpu.ops.pallas_multilayer import multilayer_step_pallas
from tracking_tpu.runner.scan import run_video as jrun
from tracking_tpu_torch.bgs import multilayer as TM
from tracking_tpu_torch.convert import state_from_numpy
from tracking_tpu_torch.ops import color as TC
from tracking_tpu_torch.ops import filters as TF
from tracking_tpu_torch.ops.multilayer import LEAF_SPEC, joint_distances, multilayer_step
from tracking_tpu_torch.ops.sort import sort_desc_maps
from tracking_tpu_torch.synth import make_clip

TIE = 1e-6  # two distances this close count as a near tie (counted, not excused)


def _pixels_near_a_tie(cfg, state, cf, pat):
    """Pixels whose two smallest joint distances, or best distance and the
    match threshold, lie within TIE: there an ulp of ``exp`` may pick
    another mode or branch."""
    A = {short: list(state[leaf].unbind(0)) for leaf, short in LEAF_SPEC}
    d = torch.stack(joint_distances(cfg, A, state["n"], cf, pat)).numpy()
    d.sort(axis=0)
    near = np.isfinite(d[1]) & (np.abs(d[1] - d[0]) < TIE)
    return near | (np.abs(d[0] - cfg.bg_prob_updating_threshold) < TIE)


@pytest.mark.parametrize("learn", [True, False], ids=["learn", "frozen"])
def test_ml_update_matches_reference_kernel(learn):
    h, w = 32, 48
    frames = make_clip(10, h, w, 3, seed=6)
    ja = JM.MultiLayerBGS()
    js, _ = jrun(ja, jnp.asarray(frames[:8]), state=ja.init(h, w, 3))  # 8 frames in
    js = jax.device_get(js)
    f3 = jnp.asarray(frames[8])
    gray = JC.bgr2gray_u8(f3).astype(jnp.float32)
    pat = np.array(jnp.stack([(gray - JM._shift_zero(gray, dx, dy) + 3.0 > 0).astype(jnp.float32)
                                for dx, dy in JM._ML_OFFSETS]))
    cf = np.ascontiguousarray(np.moveaxis(frames[8], -1, 0).astype(np.float32))
    cfg = ja.config
    lr, wlr, imw = 0.05, 0.05, 0.05
    maps, dist = multilayer_step_pallas(JM._ml_update, cfg, js, jnp.asarray(cf), jnp.asarray(pat), lr, wlr, imw,
                                        jnp.int32(9), learn, interpret=True)
    want = {k: np.asarray(v) for k, v in maps.items()}
    ts = state_from_numpy(js, device="cpu")
    scal = torch.tensor([lr, wlr, imw, 1 - lr], dtype=torch.float32)
    got, tdist = multilayer_step(TM.MultiLayerConfig(), ts, torch.from_numpy(cf), torch.from_numpy(pat), scal,
                                 torch.tensor(9, dtype=torch.int32), learn)
    near = _pixels_near_a_tie(cfg, ts, torch.from_numpy(cf), torch.from_numpy(pat))
    for k, ref in want.items():
        g = got[k].numpy()
        assert g.dtype == ref.dtype and g.shape == ref.shape, k
        np.testing.assert_array_equal(g, ref, err_msg=k)
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(dist))
    print(f"learn={learn}: every leaf and the distance equal, {int(near.sum())} px near a tie among them")
    assert int(js["n"].max()) > 1
    assert (want["n"] != js["n"]).any() == learn  # modes were added only while learning


@pytest.mark.parametrize("detect_after", [0, 3], ids=["learn", "detectAfter3"])
def test_multilayer_matches_reference(detect_after):
    frames = make_clip(17, 32, 48, 3, seed=7)
    shares, ts = run_both(JM.MultiLayerBGS(detectAfter=detect_after), TM.MultiLayerBGS(detectAfter=detect_after),
                          frames, check=assert_step_equal)
    assert shares[0] == 0.0 and 0.001 < np.mean(shares[1:]) < 0.5, shares
    assert int(ts["n"].max()) > 1


def test_gaussian_blur_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (29, 37)).astype(np.float32)
    np.testing.assert_array_equal(TF.gaussian_blur(torch.from_numpy(x), 9, 3.0).numpy(),
                                  np.asarray(jax.jit(JF.gaussian_blur, static_argnums=(1, 2))(jnp.asarray(x), 9, 3.0)))
    u = rng.integers(0, 256, (21, 30, 3), np.uint8)
    np.testing.assert_array_equal(TF.gaussian_blur(torch.from_numpy(u)).numpy(), np.asarray(JF.gaussian_blur(jnp.asarray(u))))
    np.testing.assert_array_equal(TF.gaussian_kernel1d(9, 3.0), JF.gaussian_kernel1d(9, 3.0))


def test_bgr2gray_matches_reference():
    img = np.random.default_rng(3).integers(0, 256, (17, 23, 3), np.uint8)
    img[0, :3] = [[0, 0, 0], [255, 255, 255], [255, 0, 128]]
    np.testing.assert_array_equal(TC.bgr2gray_u8(torch.from_numpy(img)).numpy(), np.asarray(JC.bgr2gray_u8(jnp.asarray(img))))
    g = img[..., 0]
    np.testing.assert_array_equal(TC.bgr2gray_u8(torch.from_numpy(g)).numpy(), g)


def test_sort_desc_maps_matches_reference():
    rng = np.random.default_rng(4)
    key = [rng.integers(0, 4, (6, 7)).astype(np.float32) for _ in range(5)]  # many ties
    key[2][0, 0] = -np.inf
    pay = [rng.integers(0, 100, (3, 6, 7)).astype(np.int32) for _ in range(5)]
    jk, jp = JGMM._sort_desc_maps([jnp.asarray(k) for k in key], [[jnp.asarray(p) for p in pay]])
    tk, tp = sort_desc_maps([torch.from_numpy(k) for k in key], [[torch.from_numpy(p) for p in pay]])
    for a, b in zip(jk, tk):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jp[0], tp[0]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
