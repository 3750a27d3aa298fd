"""The port's sharded runners on a process mesh (gloo ranks in spawned
processes on the CPU, ``parallel/dist.py``) against the JAX package's
runners on its 8-device CPU mesh, at the thread tests' sizes:
``run_video_spatial_tracked`` (SuBSENSE + CCMSPF, lockstep and pipelined)
on 2 and 4 ranks, ``run_video_spatial`` on 1 × 2, 1 × 4 and 2 × 2 meshes
(the stream replicated over the rows), ``run_video_batch_spatial`` on a
2 × 2 mesh, ``run_video_batch_shardmap`` on its 2 stream ranks and
``run_video_batch`` on it for SuBSENSE (routed to the spatial batch) and
FrameDifference (no ``ctx``: the stream ranks). Masks, SuBSENSE states,
tracker states and per-frame track positions bit for bit, against JAX
and against the port's unsharded chain. JAX's runners give the
same bits on every shard count and schedule, and its batch runners the
same bits as each other (``tests/test_mesh.py``), so one JAX run of each
kind serves the process runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mesh import BATCH, _check
from test_torch_spatial_path import FRAMES, TKW, _check as _check_tracked, _port_chain
from torch_parity import assert_tree_equal
from tracking_tpu.bgs.lbsp_family import SuBSENSE as JSuBSENSE
from tracking_tpu.core.registry import get_algorithm as j_get
from tracking_tpu.parallel import mesh as jmesh
from tracking_tpu.parallel.spatial import run_video_spatial as j_spatial
from tracking_tpu.parallel.spatial import run_video_spatial_tracked as j_tracked
from tracking_tpu.track.tracker import BlobTracker as JTracker
from tracking_tpu_torch import get_algorithm as t_get
from tracking_tpu_torch.bgs.lbsp_family import SuBSENSE as TSuBSENSE
from tracking_tpu_torch.parallel import mesh as tmesh
from tracking_tpu_torch.parallel.spatial import run_video_batch_spatial, run_video_spatial, run_video_spatial_tracked
from tracking_tpu_torch.track.tracker import BlobTracker as TTracker

_JAX = {}


def _need_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")


@pytest.fixture(scope="module")
def meshes():
    """gloo process meshes on the CPU by shape (stream, space): 1 × 2, and
    1 × 4 and 2 × 2 on one group of 4 processes; ended with the module."""
    m2 = tmesh.make_mesh(2, stream=1, device="cpu", backend="gloo")
    m4 = tmesh.make_mesh(4, stream=1, device="cpu", backend="gloo")
    yield {(1, 2): m2, (1, 4): m4, (2, 2): m4.split(2)}
    m2.close()
    m4.close()


def _jax_tracked():
    """JAX's run_video_spatial_tracked (CCMSPF) on 4 devices, once."""
    if "tracked" not in _JAX:
        st, ts, masks, xs = j_tracked(JSuBSENSE(), JTracker(trackerType="CCMSPF", **TKW), jnp.asarray(FRAMES),
                                      jmesh.make_mesh(4, stream=1))
        _JAX["tracked"] = (jax.device_get(st), jax.device_get(ts)._asdict(), np.asarray(masks), np.asarray(xs))
    return _JAX["tracked"]


def _jax_batch():
    """JAX's run_video_batch of SuBSENSE on a 2 × 2 mesh (its spatial
    batch), once."""
    if "batch" not in _JAX:
        _JAX["batch"] = jmesh.run_video_batch(JSuBSENSE(), jnp.asarray(BATCH), mesh=jmesh.make_mesh(4, stream=2))
    return _JAX["batch"]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("pipelined", [False, True], ids=["lockstep", "pipelined"])
def test_tracked_pipeline_on_processes_matches_jax(meshes, n, pipelined):
    _need_mesh()
    mesh = meshes[(1, n)]
    got = run_video_spatial_tracked(TSuBSENSE(), TTracker(trackerType="CCMSPF", **TKW), torch.from_numpy(FRAMES),
                                    pipelined=pipelined, mesh=mesh)
    _check_tracked(_jax_tracked(), got)
    _check_tracked(_port_chain("CCMSPF"), got)
    assert sum(mesh.group().last["launches"].values()) == 0  # CPU tensors: the plain versions


def test_batch_spatial_on_a_2x2_process_mesh_matches_jax(meshes):
    """4 streams × 2 row shards of 16 rows on 4 processes, each stream row
    of 2 ranks synchronising over its own ``space`` group."""
    _need_mesh()
    _check(_jax_batch(), run_video_batch_spatial(TSuBSENSE(), torch.from_numpy(BATCH), meshes[(2, 2)]))


def test_shardmap_on_2_stream_ranks_matches_jax(meshes):
    """Two stream ranks of the 2 × 2 mesh run two whole streams each; the
    ranks off ``space`` 0 hold none."""
    _need_mesh()
    _check(_jax_batch(), tmesh.run_video_batch_shardmap(TSuBSENSE(), torch.from_numpy(BATCH), meshes[(2, 2)]))


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)], ids=["1x2", "1x4", "2x2"])
def test_run_video_spatial_on_processes_matches_jax(meshes, shape):
    """One stream in row shards over the mesh's ``space`` axis; on 2 × 2
    each stream row holds the stream whole and runs it over its own
    ``space`` group (the rows' results agree, row 0's come back)."""
    _need_mesh()
    if "spatial" not in _JAX:
        st, masks = j_spatial(JSuBSENSE(), jnp.asarray(FRAMES), jmesh.make_mesh(2, stream=1))
        _JAX["spatial"] = (jax.device_get(st), np.asarray(masks))
    state, masks = run_video_spatial(TSuBSENSE(), torch.from_numpy(FRAMES), mesh=meshes[shape])
    np.testing.assert_array_equal(masks.numpy(), _JAX["spatial"][1])
    assert int((masks > 0).sum()) > 0
    assert_tree_equal(_JAX["spatial"][0], state)


@pytest.mark.parametrize("name", ["SuBSENSEBGS", "FrameDifferenceBGS"])
def test_run_video_batch_on_a_2x2_process_mesh_matches_jax(meshes, name):
    """``run_video_batch`` with a 2 × 2 mesh: SuBSENSE (``ctx``) through the
    spatial batch, FrameDifference through the stream ranks; JAX's
    ``run_video_batch`` on its 2 × 2 mesh (the spatial batch, and the
    partitioned batched scan)."""
    _need_mesh()
    if name == "SuBSENSEBGS":
        want = _jax_batch()
    else:
        want = jmesh.run_video_batch(j_get(name)(), jnp.asarray(BATCH), mesh=jmesh.make_mesh(4, stream=2))
    _check(want, tmesh.run_video_batch(t_get(name)(), torch.from_numpy(BATCH), mesh=meshes[(2, 2)]))
