"""``run_video_batch`` on a 2-D mesh (4 streams × 2 row shards of 16 rows,
``make_mesh(8)``) in the port and in the JAX package, on
``tests/test_mesh.py``'s batch: SuBSENSE v1 and LOBSTER through the stream
× space runner (``run_video_batch_spatial``), FrameDifference through the
branch where the JAX package lets XLA partition the batch. Masks and every
state leaf bit for bit, and the port's against its own unsharded runs.
SuBSENSE v3 is ``tests/test_torch_mesh_v3.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mesh import BATCH, _check, _need_mesh
from torch_parity import assert_tree_equal, count_calls
from tracking_tpu.core.registry import get_algorithm as j_get
from tracking_tpu.parallel import mesh as jmesh
from tracking_tpu_torch import get_algorithm as t_get
from tracking_tpu_torch.parallel import mesh as tmesh
from tracking_tpu_torch.parallel import spatial as tspatial


def run_2d(monkeypatch, name):
    """(JAX's, the port's) run_video_batch on the 8-rank mesh; the port's
    must go through run_video_batch_spatial."""
    _need_mesh()
    calls = count_calls(monkeypatch, tspatial, "run_video_batch_spatial")
    want = jmesh.run_video_batch(j_get(name)(), jnp.asarray(BATCH), mesh=jmesh.make_mesh(8))
    mesh = tmesh.make_mesh(8, device="cpu")
    assert mesh.shape == {"stream": 4, "space": 2}
    got = tmesh.run_video_batch(t_get(name)(), torch.from_numpy(BATCH), mesh=mesh)
    assert len(calls) == 1
    return want, got


def unsharded(name, frames):
    """The port's per-stream runs, stacked: (states, masks)."""
    from tracking_tpu_torch.convert import stack_states
    from tracking_tpu_torch.runner.scan import run_video

    runs = [run_video(t_get(name)(), torch.from_numpy(f)) for f in frames]
    return stack_states([r[0] for r in runs]), torch.stack([r[1] for r in runs])


@pytest.mark.parametrize("name", ["SuBSENSEBGS", "LOBSTERBGS"])
def test_stream_by_space_matches_jax(monkeypatch, name):
    want, got = run_2d(monkeypatch, name)
    _check(want, got)
    st, masks = unsharded(name, BATCH)
    assert torch.equal(masks, got[1])
    assert_tree_equal(st, got[0])


def test_frame_difference_takes_the_unsharded_branch():
    """No ``ctx`` in its step: JAX partitions the batch with XLA, the port
    runs each stream unsharded on the mesh's device."""
    _need_mesh()
    name = "FrameDifferenceBGS"
    want = jmesh.run_video_batch(j_get(name)(), jnp.asarray(BATCH), mesh=jmesh.make_mesh(8))
    got = tmesh.run_video_batch(t_get(name)(), torch.from_numpy(BATCH), mesh=tmesh.make_mesh(8, device="cpu"))
    _check(want, got)
    with pytest.raises(ValueError, match="spatial-context"):
        tspatial.run_video_batch_spatial(t_get(name)(), torch.from_numpy(BATCH), tmesh.make_mesh(8, device="cpu"))


def test_short_slabs_take_the_unsharded_branch(monkeypatch):
    """4 row shards of 8 rows fit the halo; 8 of 4 do not, and run as the
    JAX package routes them: unsharded per stream."""
    calls = count_calls(monkeypatch, tspatial, "run_video_batch_spatial")
    frames = torch.from_numpy(BATCH[:2, :3])
    st, masks = unsharded("LOBSTERBGS", BATCH[:2, :3])
    for space, n_calls in ((4, 1), (8, 1)):
        got = tmesh.run_video_batch(t_get("LOBSTERBGS")(), frames, mesh=tmesh.make_mesh(2 * space, stream=2,
                                                                                        device="cpu"))
        assert len(calls) == n_calls
        assert torch.equal(got[1], masks)
        assert_tree_equal(st, got[0])
