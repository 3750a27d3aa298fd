"""Batches placed on a mesh (``tracking_tpu_torch.parallel.placed``): gloo
ranks in spawned processes on the CPU (and the thread mesh, through the
same API), against the JAX package's runners chained through their
``states=`` on its 8-device CPU mesh, at ``tests/test_mesh.py``'s sizes.

- SuBSENSE on 2 × 2 (``run_video_batch_spatial``) and 4 × 1
  (``run_video_batch_shardmap``) in 3 chunks of 2 frames, LOBSTER on 2 × 2
  in 2 of 3, with the states kept placed: chunk 0 from a placed batch's
  frames with the states made on the ranks, chunk 1 from a plain tensor,
  chunk 2 placed again. Masks of every chunk and the gathered final states
  bit for bit against JAX's chain.
- The tracked path (CCMSPF, pipelined) on 1 × 4 in 2 chunks of 6 frames,
  the tracker state kept placed (replicated), against JAX's
  ``run_video_spatial_tracked`` chained with ``states=`` and
  ``tracker_state=``: masks, SuBSENSE state and the tracker bit for bit
  (``tests/test_torch_spatial_path.py``).
- What crosses: a chained call with placed states moves the frames in and
  the masks out (``DistGroup.last``'s bytes), nothing of a state; a
  placed batch crosses once, block by block.
- A handle reused gives the same result; ``delete()`` and a dropped handle
  empty the ranks' registries; a handle on another layout of the same
  ranks runs there (``tests/test_torch_reshard.py`` holds the resharding
  to JAX); one on other ranks, a deleted one, one after ``close`` and one
  whose rank died raise.

JAX's runners build a new ``shard_map`` at each call, so each chunk
compiles; each JAX chain runs once for the module (``_JAX``)."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mesh import BATCH, _need_mesh
from test_torch_spatial_path import FRAMES, TKW, _check as _check_tracked
from torch_parity import assert_tree_equal
from tracking_tpu.core.registry import get_algorithm as j_get
from tracking_tpu.parallel import mesh as jmesh
from tracking_tpu.parallel.spatial import run_video_batch_spatial as j_batch_spatial
from tracking_tpu.parallel.spatial import run_video_spatial_tracked as j_tracked
from tracking_tpu.track.tracker import BlobTracker as JTracker
from tracking_tpu_torch import get_algorithm as t_get
from tracking_tpu_torch.parallel import mesh as tmesh
from tracking_tpu_torch.parallel.placed import MeshArray, place
from tracking_tpu_torch.parallel.spatial import run_video_batch_spatial, run_video_spatial_tracked
from tracking_tpu_torch.track.tracker import BlobTracker as TTracker

CHUNKS = ((0, 2), (2, 4), (4, 6))  # BATCH's 6 frames
TRACKED_CHUNKS = ((0, 6), (6, 12))  # FRAMES' 12
_JAX = {}


@pytest.fixture(scope="module")
def procs():
    """One group of 4 gloo processes on the CPU, as 2 × 2, 4 × 1 and 1 × 4;
    ended with the module."""
    m = tmesh.make_mesh(4, stream=2, device="cpu", backend="gloo")
    yield {(2, 2): m, (4, 1): m.split(4), (1, 4): m.split(1)}
    m.close()


def meshes(procs, kind, shape):
    if kind == "processes":
        return procs[shape]
    return tmesh.make_mesh(4, stream=shape[0], device="cpu")


def _jax_batch(name, shape, chunks=CHUNKS):
    """JAX's chain of ``chunks``: the shardmap on 4 × 1, the spatial batch
    on 2 × 2. (states, masks of every chunk along T)."""
    key = (name, shape)
    if key not in _JAX:
        _need_mesh()
        mesh = jmesh.make_mesh(4, stream=shape[0])
        st, masks = None, []
        for a, b in chunks:
            frames = jnp.asarray(BATCH[:, a:b])
            if shape == (4, 1):
                st, m = jmesh.run_video_batch_shardmap(j_get(name)(), frames, mesh, states=st)
            else:
                st, m = j_batch_spatial(j_get(name)(), frames, mesh, states=st)
            masks.append(np.asarray(m))
        _JAX[key] = (jax.device_get(st), np.concatenate(masks, axis=1))
    return _JAX[key]


def _runner(shape):
    return tmesh.run_video_batch_shardmap if shape == (4, 1) else run_video_batch_spatial


def _port_batch(name, mesh, shape, chunks=CHUNKS):
    """The port's chain of ``chunks`` with the states placed: chunk 0 from
    the placed batch (states made on the ranks), chunk 1 from a tensor,
    chunk 2 from the placed batch. (placed states, masks along T, what
    crossed in each call)."""
    run, algo = _runner(shape), t_get(name)()
    placed = tmesh.shard_video_batch(torch.from_numpy(BATCH), mesh)
    st, masks, moved = None, [], []
    for k, (a, b) in enumerate(chunks):
        frames = torch.from_numpy(BATCH[:, a:b]) if k == 1 else placed.narrow(1, a, b - a)
        st, m = run(algo, frames, mesh, states=st)
        assert isinstance(st, MeshArray) and isinstance(m, torch.Tensor)
        masks.append(m)
        if mesh.backend is not None:
            moved.append((mesh.group().last["bytes_in"], mesh.group().last["bytes_out"]))
    placed.delete()
    return st, torch.cat(masks, dim=1), moved


def _check_batch(want, st, masks):
    np.testing.assert_array_equal(masks.numpy(), want[1], err_msg="masks")
    assert int((masks > 0).sum()) > 0
    assert_tree_equal(want[0], st.gather(), "states")


@pytest.mark.parametrize("kind", ["processes", "threads"])
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_subsense_chain_with_placed_states_matches_jax(procs, kind, shape):
    """Masks of all chunks and the gathered final states equal JAX's chain;
    on the processes the chained calls move no state: the plain chunk's
    frames in, every chunk's masks out."""
    want = _jax_batch("SuBSENSEBGS", shape)
    mesh = meshes(procs, kind, shape)
    st, masks, moved = _port_batch("SuBSENSEBGS", mesh, shape)
    _check_batch(want, st, masks)
    if kind == "processes":
        chunk_masks = masks[:, :2].numel()  # u8, 2 frames of the 4 streams
        assert moved == [(0, chunk_masks), (BATCH[:, 2:4].nbytes, chunk_masks), (0, chunk_masks)]
        assert st._blocks is None  # the parent holds the handle, no tensor


def test_lobster_chain_on_2x2_matches_jax(procs):
    """LOBSTER's slab step (kernel #6's plain version here) on a chain of 2
    chunks of 3 frames (one JAX compile a chunk)."""
    chunks = ((0, 3), (3, 6))
    want = _jax_batch("LOBSTERBGS", (2, 2), chunks)
    st, masks, _ = _port_batch("LOBSTERBGS", procs[(2, 2)], (2, 2), chunks)
    _check_batch(want, st, masks)


def _jax_tracked():
    """JAX's run_video_spatial_tracked (CCMSPF, pipelined) on 1 × 4, chained
    over TRACKED_CHUNKS: (bgs state, tracker state, masks, xs)."""
    if "tracked" not in _JAX:
        _need_mesh()
        mesh = jmesh.make_mesh(4, stream=1)
        algo, tracker = j_get("SuBSENSEBGS")(), JTracker(trackerType="CCMSPF", **TKW)
        st = ts = None
        masks, xs = [], []
        for a, b in TRACKED_CHUNKS:
            st, ts, m, x = j_tracked(algo, tracker, jnp.asarray(FRAMES[a:b]), mesh, states=st, tracker_state=ts,
                                     pipelined=True)
            masks.append(np.asarray(m))
            xs.append(np.asarray(x))
        _JAX["tracked"] = (jax.device_get(st), jax.device_get(ts)._asdict(), np.concatenate(masks),
                           np.concatenate(xs))
    return _JAX["tracked"]


@pytest.mark.parametrize("kind", ["processes", "threads"])
def test_tracked_chain_with_placed_states_matches_jax(procs, kind):
    """Chunk 0 from placed frames (both states made on the ranks), chunk 1
    from a tensor with both states placed; the second call moves the
    frames in, the masks and rank 0's tracks out."""
    want = _jax_tracked()
    mesh = meshes(procs, kind, (1, 4))
    algo, tracker = t_get("SuBSENSEBGS")(), TTracker(trackerType="CCMSPF", **TKW)
    (a, b), (c, d) = TRACKED_CHUNKS
    st, ts, m0, x0 = run_video_spatial_tracked(algo, tracker, place(torch.from_numpy(FRAMES[a:b]), mesh,
                                                                    (None, "space")), pipelined=True, mesh=mesh)
    st, ts, m1, x1 = run_video_spatial_tracked(algo, tracker, torch.from_numpy(FRAMES[c:d]), states=st,
                                               tracker_state=ts, pipelined=True, mesh=mesh)
    assert isinstance(st, MeshArray) and isinstance(ts, MeshArray)
    if kind == "processes":
        last = mesh.group().last
        assert (last["bytes_in"], last["bytes_out"]) == (FRAMES[c:d].nbytes, m1.numel() + x1.numel() * x1.element_size())
    _check_tracked(want, (st.gather(), ts.gather(), torch.cat([m0, m1]), torch.cat([x0, x1])))


def test_a_placed_handle_runs_twice_alike(procs):
    """The ranks step clones of the placed states: the input handle keeps
    its state, and the same handle run again gives the same masks and
    states."""
    mesh = procs[(2, 2)]
    algo = t_get("SuBSENSEBGS")()
    st, _ = run_video_batch_spatial(algo, tmesh.shard_video_batch(torch.from_numpy(BATCH[:, :2]), mesh), mesh)
    before = st.gather()
    frames = torch.from_numpy(BATCH[:, 2:4])
    st1, m1 = run_video_batch_spatial(algo, frames, mesh, states=st)
    st2, m2 = run_video_batch_spatial(algo, frames, mesh, states=st)
    assert torch.equal(m1, m2)
    assert_tree_equal(st1.gather(), st2.gather())
    assert_tree_equal(before, st.gather())


def test_released_handles_leave_the_ranks(procs):
    """20 chained calls leave the ranks holding the placed batch and the
    newest states only (each step's chunk and the older states were
    dropped); a dropped handle and ``delete()`` empty the registries."""
    mesh = procs[(4, 1)]
    group = mesh.group()
    algo = t_get("FrameDifferenceBGS")()
    placed = tmesh.shard_video_batch(torch.from_numpy(BATCH), mesh)
    st = None
    for k in range(20):
        st, _ = tmesh.run_video_batch_shardmap(algo, placed.narrow(1, k % 6, 1), mesh, states=st)
    assert group.held() == [sorted([placed._hid, st._hid])] * mesh.size
    del st
    gc.collect()
    assert group.held() == [[placed._hid]] * mesh.size
    placed.delete()
    assert group.held() == [[]] * mesh.size
    with pytest.raises(RuntimeError, match="deleted"):
        placed.gather()


def test_a_handle_on_another_layout_raises(procs):
    """A frame batch placed on 2 × 2 runs on the 4 × 1 layout of the same
    processes (the call reshards it, moving nothing through the parent)
    and gives the thread mesh's masks; a 2 × 2 handle on threads (other
    ranks) raises; the handle stays usable."""
    algo = t_get("SuBSENSEBGS")()
    placed = tmesh.shard_video_batch(torch.from_numpy(BATCH[:, :2]), procs[(2, 2)])
    _, masks = tmesh.run_video_batch_shardmap(algo, placed, procs[(4, 1)])
    assert procs[(4, 1)].group().last["bytes_in"] == 0
    _, want = tmesh.run_video_batch_shardmap(algo, torch.from_numpy(BATCH[:, :2]), tmesh.make_mesh(4, stream=4,
                                                                                                    device="cpu"))
    assert torch.equal(masks, want) and int((masks > 0).sum()) > 0
    with pytest.raises(ValueError, match="other ranks"):
        run_video_batch_spatial(algo, placed, tmesh.make_mesh(4, stream=2, device="cpu"))
    np.testing.assert_array_equal(placed.gather().numpy(), BATCH[:, :2])
    assert procs[(2, 2)].group().last["bytes_out"] == BATCH[:, :2].nbytes


def test_placing_a_host_batch_moves_each_block_once(procs):
    """``shard_video_batch`` of a CPU tensor: each rank's block crosses
    once (the batch's bytes in all, nothing back), and the blocks join to
    the batch."""
    mesh = procs[(2, 2)]
    placed = tmesh.shard_video_batch(torch.from_numpy(BATCH), mesh)
    last = mesh.group().last
    assert (last["bytes_in"], last["bytes_out"]) == (BATCH.nbytes, 0)
    assert placed.shape == BATCH.shape
    np.testing.assert_array_equal(placed.gather().numpy(), BATCH)


def test_closed_or_dead_groups_raise():
    """After ``close`` a handle's gather and a call with it raise; a rank
    that died fails the next call, which ends the group."""
    algo = t_get("FrameDifferenceBGS")()
    with tmesh.make_mesh(2, stream=2, device="cpu", backend="gloo") as mesh:
        st, _ = tmesh.run_video_batch_shardmap(algo, tmesh.shard_video_batch(torch.from_numpy(BATCH[:, :2]), mesh),
                                               mesh)
    with pytest.raises(RuntimeError, match="closed"):
        st.gather()
    with pytest.raises(RuntimeError, match="closed"):
        tmesh.run_video_batch_shardmap(algo, torch.from_numpy(BATCH[:, 2:4]), mesh, states=st)
    with tmesh.make_mesh(2, stream=2, device="cpu", backend="gloo") as mesh:
        st, _ = tmesh.run_video_batch_shardmap(algo, tmesh.shard_video_batch(torch.from_numpy(BATCH[:, :2]), mesh),
                                               mesh)
        mesh.group()._procs[1].kill()
        mesh.group()._procs[1].join(10)
        with pytest.raises(RuntimeError, match="rank 1"):
            tmesh.run_video_batch_shardmap(algo, torch.from_numpy(BATCH[:, 2:4]), mesh, states=st)
        assert mesh.group().closed
