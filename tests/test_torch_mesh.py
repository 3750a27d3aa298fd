"""The port's mesh and stream-batched runners (``tracking_tpu_torch.parallel.
mesh``) against the JAX package's ``tracking_tpu.parallel.mesh`` on the
8-device CPU mesh of ``tests/conftest.py``: the mesh's split, the batch's
blocks, ``run_video_batch`` without a mesh and ``run_video_batch_shardmap``,
masks and every state leaf bit for bit; and the 2-D shard group's axis
views. The batch is ``tests/test_mesh.py``'s: 4 streams × 6 frames at
32×48."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal
from tracking_tpu.core.registry import get_algorithm as j_get
from tracking_tpu.parallel import mesh as jmesh
from tracking_tpu_torch import get_algorithm as t_get
from tracking_tpu_torch.convert import split_states, stack_states
from tracking_tpu_torch.parallel import mesh as tmesh
from tracking_tpu_torch.parallel.mesh import ShardGroup


def _batch():
    """tests/test_mesh.py's batch: a moving bright square per stream."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 200, (4, 1, 32, 48, 3), np.uint8)
    frames = np.repeat(base, 6, axis=1)
    for b in range(4):
        for t in range(6):
            frames[b, t, 8 + t : 16 + t, 10 + 2 * t : 20 + 2 * t] = 255
    return frames


BATCH = _batch()


def _need_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")


def _check(want, got):
    """want: JAX's (stacked state, masks); got: the port's."""
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]), err_msg="masks")
    assert int((got[1] > 0).sum()) > 0
    assert_tree_equal(jax.device_get(want[0]), got[0], "states")


@pytest.mark.parametrize(
    "n,stream", [(1, None), (2, None), (4, None), (8, None), (1, 1), (2, 1), (2, 2), (4, 1), (4, 4), (8, 2), (8, 4),
                 (8, 8)])
def test_make_mesh_splits_as_jax(n, stream):
    _need_mesh()
    want = dict(jmesh.make_mesh(n, stream=stream).shape)
    got = tmesh.make_mesh(n, stream=stream, device="cpu")
    assert got.shape == want
    assert got.size == n and got.device == torch.device("cpu")


def test_make_mesh_refuses_what_jax_cannot_split():
    _need_mesh()
    with pytest.raises(ValueError):
        jmesh.make_mesh(8, stream=3)
    with pytest.raises(ValueError, match="do not split"):
        tmesh.make_mesh(8, stream=3, device="cpu")
    assert tmesh.make_mesh(device="cpu").shape == {"stream": 1, "space": 1}  # one rank unless asked
    assert tmesh.make_mesh().device == torch.device("cuda")  # the card unless asked


def test_video_batch_spec():
    assert tmesh.video_batch_spec() == tuple(jmesh.video_batch_spec())


@pytest.mark.parametrize("gray", [False, True], ids=["bthwc", "bthw"])
@pytest.mark.parametrize("stream", [4, 2])
def test_shard_video_batch_blocks_equal_jax_shards(gray, stream):
    """Rank i · space + j holds the JAX shard on the mesh's device (i, j),
    read through the placed batch's handle."""
    _need_mesh()
    frames = BATCH[..., 0] if gray else BATCH
    jm = jmesh.make_mesh(8, stream=stream)
    placed = jmesh.shard_video_batch(jnp.asarray(frames), jm)
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    tm = tmesh.make_mesh(8, stream=stream, device="cpu")
    handle = tmesh.shard_video_batch(torch.from_numpy(frames), tm)
    assert handle.shape == frames.shape
    blocks = handle.blocks()
    assert len(blocks) == tm.size
    for i in range(tm.stream):
        for j in range(tm.space):
            np.testing.assert_array_equal(blocks[i * tm.space + j].numpy(), by_device[jm.devices[i, j]])


@pytest.mark.parametrize("name", ["FrameDifferenceBGS", "MixtureOfGaussianV2BGS", "SuBSENSEBGS"])
def test_run_video_batch_without_a_mesh(name):
    want = jmesh.run_video_batch(j_get(name)(), jnp.asarray(BATCH))
    got = tmesh.run_video_batch(t_get(name)(), torch.from_numpy(BATCH))
    _check(want, got)


@pytest.mark.parametrize("name", ["MixtureOfGaussianV2BGS", "SuBSENSEBGS"])
def test_run_video_batch_shardmap(name):
    """Four stream ranks, one stream each, no collective."""
    _need_mesh()
    want = jmesh.run_video_batch_shardmap(j_get(name)(), jnp.asarray(BATCH), jmesh.make_mesh(8, stream=4))
    got = tmesh.run_video_batch_shardmap(t_get(name)(), torch.from_numpy(BATCH),
                                         tmesh.make_mesh(8, stream=4, device="cpu"))
    _check(want, got)


def test_states_resume_a_batch():
    """3 frames, then 3 more from the returned stacked states (split into
    per-stream copies), equal 6 frames in one run; the caller's stacked
    state is left as it was."""
    algo = t_get("SuBSENSEBGS")()
    frames = torch.from_numpy(BATCH)
    st_all, m_all = tmesh.run_video_batch(algo, frames)
    st3, m3 = tmesh.run_video_batch(algo, frames[:, :3])
    kept = split_states(st3, 4)
    st6, m6 = tmesh.run_video_batch(algo, frames[:, 3:], states=st3)
    assert torch.equal(torch.cat([m3, m6], dim=1), m_all)
    assert_tree_equal(st_all, st6)
    assert_tree_equal(stack_states(kept), st3)


def test_split_states_of_a_jax_batch():
    """A vmapped JAX state converts and splits into the per-stream states
    of the streams' own runs."""
    from tracking_tpu.runner.scan import run_video as jrun
    from tracking_tpu_torch.convert import state_from_numpy

    algo = j_get("MixtureOfGaussianV2BGS")()
    jst, _ = jmesh.run_video_batch(algo, jnp.asarray(BATCH))
    per = split_states(state_from_numpy(jax.device_get(jst), device="cpu"), 4)
    for b in range(4):
        one, _ = jrun(algo, jnp.asarray(BATCH[b]))
        assert_tree_equal(jax.device_get(one), per[b], f"stream {b}")
    with pytest.raises(ValueError, match="holds no 3 streams"):
        split_states(state_from_numpy(jax.device_get(jst), device="cpu"), 3)


def test_axis_views_synchronise_each_row_alone():
    """A 2 × 4 group: psum and all_gather over a rank's ``space`` view see
    its stream row only, over its ``stream`` view its column only; the rows
    run different numbers of collectives (row 1 three more rounds) without
    a deadlock, as SuBSENSE's auto-reset and the fill's rounds may."""
    group = ShardGroup(8, timeout=60.0, axes={"stream": 2, "space": 4})

    def fn(rank, comm, x):
        space, stream = comm.axis("space"), comm.axis("stream")
        assert comm.axis("space") is space and (space.n, stream.n) == (4, 2)
        assert (space.rank, stream.rank) == (rank % 4, rank // 4)
        rounds = 1 + 3 * comm.coords["stream"]
        for _ in range(rounds):
            row = space.psum(x)
        return row, space.all_gather(x), stream.psum(x), comm.psum(x)

    xs = [torch.tensor([float(r)]) for r in range(8)]
    out = group.run(fn, xs)
    for r, (row, gathered, col, total) in enumerate(out):
        i, j = divmod(r, 4)
        assert float(row) == sum(range(4 * i, 4 * i + 4))
        assert gathered.tolist() == [float(4 * i + k) for k in range(4)]
        assert float(col) == j + (4 + j)
        assert float(total) == 28.0


def test_a_failing_rank_releases_every_row():
    """A rank that raises aborts the barriers of every row and view."""
    group = ShardGroup(4, timeout=60.0, axes={"stream": 2, "space": 2})

    def fn(rank, comm, _):
        if rank == 3:
            raise RuntimeError("rank 3 fails")
        comm.axis("space").psum(torch.ones(1))
        comm.psum(torch.ones(1))

    with pytest.raises(RuntimeError, match="rank 3 fails"):
        group.run(fn, [None] * 4)
    assert not [t for t in threading.enumerate() if t.name.startswith("shard-")]
    with pytest.raises(ValueError, match="do not hold"):
        ShardGroup(6, axes={"stream": 2, "space": 2})
