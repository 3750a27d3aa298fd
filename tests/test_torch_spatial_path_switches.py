"""The row-sharded SuBSENSE pipeline of the port under its switches and
branches (``tracking_tpu_torch.parallel.spatial``), split from
``tests/test_torch_spatial_path.py`` so that each file stays short under
xdist: SuBSENSE v3 and the fused switch in 2 shards against the JAX
package's ``run_video_spatial`` under the same switch, and the motion
analysis's auto-reset refresh in 4 shards against the port's unsharded
run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_spatial_path import _spatial_stream
from torch_parity import assert_tree_equal
from tracking_tpu.bgs.lbsp_family import SuBSENSE as JSuBSENSE
from tracking_tpu_torch.bgs.lbsp_family import SuBSENSE as TSuBSENSE
from tracking_tpu_torch.parallel.spatial import run_video_spatial


@pytest.mark.parametrize("env", [{"TRACKING_TPU_CONSENSUS": "v3"}, {"TRACKING_TPU_FUSED": "1"}],
                         ids=["v3", "fused"])
def test_v3_and_fused_states_refuse_ctx(monkeypatch, env):
    """v3 and the fused switch under ``ctx`` in 2 shards against the JAX
    package's ``run_video_spatial`` under the same switch: v3 walks its slab
    mode with ``bg_sum`` row-sharded; the fused switch runs v1 there in both
    packages (the fused step takes no ``ctx``), so no fused step is called.
    v3 in 8 shards: ``tests/test_torch_spatial_lobster.py``."""
    import tracking_tpu_torch.bgs.lbsp_family as TLF
    from torch_parity import count_calls
    from tracking_tpu.parallel.mesh import make_mesh
    from tracking_tpu.parallel.spatial import run_video_spatial as j_run_spatial

    if len(jax.devices()) < 2:
        pytest.skip("needs the CPU mesh")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fused = {name: count_calls(monkeypatch, TLF, name) for name in ("consensus_feedback", "consensus")}
    frames = _spatial_stream(64, 48)
    j_state, j_masks = j_run_spatial(JSuBSENSE(), jnp.asarray(frames), make_mesh(2, stream=1))
    state, masks = run_video_spatial(TSuBSENSE(), torch.from_numpy(frames), n_shards=2)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(j_masks))
    assert int((masks > 0).sum()) > 0
    assert_tree_equal(jax.device_get(j_state), state)
    assert ("bg_sum" in state) == ("TRACKING_TPU_CONSENSUS" in env)
    assert len(fused["consensus_feedback"]) == 0
    assert len(fused["consensus"]) == (0 if "TRACKING_TPU_CONSENSUS" in env else 2 * len(frames))


def test_auto_reset_refresh_in_4_shards():
    """The motion analysis's auto-reset refresh, the branch in which the
    ranks exchange halos only when the (replicated) trigger fires: the
    mid-stream state of tests/test_torch_subsense_scaling.py (288×544, long-
    and short-term means 120 apart) through 4 shards equals the port's
    unsharded run, which that test pins to the JAX package."""
    from tracking_tpu_torch.runner.scan import run_video as trun
    from tracking_tpu_torch.synth import make_clip

    h, w = 288, 544
    frames = torch.from_numpy(make_clip(5, h, w, 3, seed=5, brightness_jump=(3, 45)))
    algo = TSuBSENSE()
    st = algo.warm_start(algo.init(h, w, 3, device="cpu"), frames[0])
    st = dict(st, t=torch.tensor(100, dtype=torch.int32), ds_lt=tuple(torch.zeros_like(d) for d in st["ds_lt"]),
              ds_st=tuple(torch.full_like(d, 120.0) for d in st["ds_st"]))
    got_state, got = run_video_spatial(algo, frames[1:], n_shards=4, states=st)  # splits copies of st
    want_state, want = trun(algo, frames[1:], state=st)
    assert int(want_state["cooldown"]) == 25 - 4  # frame 1 triggered the refresh
    assert torch.equal(got, want)
    assert_tree_equal(want_state, got_state)
