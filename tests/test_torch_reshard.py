"""Placed batches that change layout (``MeshArray.reshard``, and the runners'
resharding of a placed input), on the thread mesh and on 4 gloo processes
on the CPU, at ``tests/test_torch_mesh.py``'s batch (4 streams × 6 frames
at 32×48×3; 1 × 4 leaves 8 rows a shard, the halo).

- The chain against JAX: SuBSENSE in 3 chunks of 2 frames,
  ``run_video_batch_shardmap`` on 4 × 1, then ``run_video_batch_spatial`` on
  2 × 2, then on 1 × 4, the states kept placed from each call to the next
  and the frames placed once on 4 × 1 and narrowed, so both reshard; the
  JAX package's same chain through ``states=`` on 4 of its 8 CPU devices
  (``jax.device_put`` and ``jit`` reshard there). Masks of every chunk and
  the gathered final states bit for bit.
- Round trips A → B → A over every ordered pair of the three layouts, on a
  stacked SuBSENSE state: the gathers equal the original and the old handle
  keeps its blocks; on the processes a reshard moves nothing through the
  parent, and its ``bytes_moved`` equals the bytes counted here from the two
  metas (each rank's new block less what it held itself).
- Holders: a stream batch's states on 2 × 2 live on the ``space`` 0 ranks;
  they reshard to 4 × 1 and back, and run on 4 × 1.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_mesh import BATCH, _need_mesh
from torch_parity import assert_tree_equal
from tracking_tpu.core.registry import get_algorithm as j_get
from tracking_tpu.parallel import mesh as jmesh
from tracking_tpu.parallel.spatial import run_video_batch_spatial as j_batch_spatial
from tracking_tpu_torch import get_algorithm as t_get
from tracking_tpu_torch.convert import stack_states
from tracking_tpu_torch.parallel import mesh as tmesh
from tracking_tpu_torch.parallel.placed import MeshArray, leaves, mesh_coords, place
from tracking_tpu_torch.parallel.spatial import row_rule, run_video_batch_spatial

CHUNKS = ((0, 2), (2, 4), (4, 6))
LAYOUTS = ((4, 1), (2, 2), (1, 4))  # (stream, space): the chain's order
_JAX = {}


@pytest.fixture(scope="module")
def procs():
    """One group of 4 gloo processes on the CPU, laid out as the three
    layouts; ended with the module."""
    m = tmesh.make_mesh(4, stream=4, device="cpu", backend="gloo")
    yield {(s, 4 // s): m.split(s) for s, _ in LAYOUTS}
    m.close()


def meshes(procs, kind):
    if kind == "processes":
        return procs
    return {(s, p): tmesh.make_mesh(4, stream=s, device="cpu") for s, p in LAYOUTS}


def _jax_chain():
    """JAX's chain: (final states, masks of every chunk along T)."""
    if "chain" not in _JAX:
        _need_mesh()
        st, masks = None, []
        for (a, b), (s, _) in zip(CHUNKS, LAYOUTS):
            mesh, frames = jmesh.make_mesh(4, stream=s), jax.numpy.asarray(BATCH[:, a:b])
            if s == 4:
                st, m = jmesh.run_video_batch_shardmap(j_get("SuBSENSEBGS")(), frames, mesh, states=st)
            else:
                st, m = j_batch_spatial(j_get("SuBSENSEBGS")(), frames, mesh, states=st)
            masks.append(np.asarray(m))
        _JAX["chain"] = (jax.device_get(st), np.concatenate(masks, axis=1))
    return _JAX["chain"]


@pytest.mark.parametrize("kind", ["processes", "threads"])
def test_chain_across_layouts_matches_jax(procs, kind):
    """4 × 1 → 2 × 2 → 1 × 4 with the states and frames placed: each call
    reshards what it is given, and masks and final states equal JAX's."""
    want = _jax_chain()
    ms = meshes(procs, kind)
    algo = t_get("SuBSENSEBGS")()
    placed = tmesh.shard_video_batch(torch.from_numpy(BATCH), ms[(4, 1)])
    st, masks = None, []
    for (a, b), layout in zip(CHUNKS, LAYOUTS):
        frames = placed.narrow(1, a, b - a)
        if layout == (4, 1):
            st, m = tmesh.run_video_batch_shardmap(algo, frames, ms[layout], states=st)
        else:
            st, m = run_video_batch_spatial(algo, frames, ms[layout], states=st)
        assert isinstance(st, MeshArray) and st.mesh.shape == ms[layout].shape
        masks.append(m)
    masks = torch.cat(masks, dim=1)
    np.testing.assert_array_equal(masks.numpy(), want[1], err_msg="masks")
    assert int((masks > 0).sum()) > 0
    assert_tree_equal(want[0], st.gather(), "states")
    np.testing.assert_array_equal(placed.gather().numpy(), BATCH)  # the frames' handle kept its blocks


def _states():
    """A stacked SuBSENSE state of BATCH's 4 streams after one frame."""
    algo = t_get("SuBSENSEBGS")()
    sts = []
    for f in torch.from_numpy(BATCH):
        s = algo.warm_start(algo.init(32, 48, 3, device="cpu"), f[0])
        sts.append(algo.step(s, f[1])[0])
    return stack_states(sts)


STATES = _states()


def _moved_bytes(old, new) -> int:
    """The bytes a reshard must send rank to rank, counted from the metas:
    for each rank, its new block of each leaf less the part of it whose
    source (the old block at coordinate 0 of the axes that split no dim of
    the leaf) is the rank itself."""
    total = 0
    for a, b in zip(leaves(old.meta), leaves(new.meta)):
        size = torch.empty((), dtype=a.dtype).element_size()
        for r in new.holders:
            cn, co = mesh_coords(r, new.mesh.shape), mesh_coords(r, old.mesh.shape)
            mine = all(co[ax] == 0 for ax in old.mesh.shape if ax not in a.dims)
            block = own = 1
            for d, n in enumerate(a.shape):
                lo, hi = 0, n
                if b.dims[d] is not None:
                    part = n // new.mesh.shape[b.dims[d]]
                    lo, hi = cn[b.dims[d]] * part, (cn[b.dims[d]] + 1) * part
                olo, ohi = 0, n
                if a.dims[d] is not None:
                    part = n // old.mesh.shape[a.dims[d]]
                    olo, ohi = co[a.dims[d]] * part, (co[a.dims[d]] + 1) * part
                block *= hi - lo
                own *= max(0, min(hi, ohi) - max(lo, olo))
            total += (block - (own if mine and r in old.holders else 0)) * size
    return total


@pytest.mark.parametrize("kind", ["processes", "threads"])
@pytest.mark.parametrize("a,b", [(a, b) for a in LAYOUTS for b in LAYOUTS if a != b],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_round_trip_between_layouts(procs, kind, a, b):
    """A → B → A of the stacked state (B on ``stream``, rows on ``space``):
    each gather equals the original, and the handles resharded from keep
    their blocks; on the processes each reshard moves 0 bytes through the
    parent and ``bytes_moved`` equal to the count from the metas."""
    ms = meshes(procs, kind)
    rule = row_rule(32, batched=True)
    x = place(STATES, ms[a], ("stream",)).reshard(ms[a], rule)
    y = x.reshard(ms[b], rule)
    last_b = ms[b].group().last if kind == "processes" else None
    z = y.reshard(ms[a], rule)
    last_a = ms[a].group().last if kind == "processes" else None
    assert y.mesh.shape == ms[b].shape and z.mesh.shape == ms[a].shape
    for h in (y, z, x):
        assert_tree_equal(STATES, h.gather(), f"{h.layout}")
    if kind == "processes":
        for last, old, new in ((last_b, x, y), (last_a, y, z)):
            want = _moved_bytes(old, new)
            assert (last["bytes_in"], last["bytes_out"], last["bytes_moved"]) == (0, 0, want), (old, new)
            assert want > 0


@pytest.mark.parametrize("kind", ["processes", "threads"])
def test_stream_states_on_space_zero_ranks_reshard(procs, kind):
    """run_video_batch_shardmap on 2 × 2 keeps its states on the ``space`` 0
    ranks (0 and 2); resharded to 4 × 1 and back they gather to the same
    tree, and the 4 × 1 shardmap runs from the 2 × 2 handle as from the
    gathered states."""
    ms = meshes(procs, kind)
    algo = t_get("FrameDifferenceBGS")()
    st, _ = tmesh.run_video_batch_shardmap(algo, torch.from_numpy(BATCH[:, :2]), ms[(2, 2)],
                                           states=place(STATES_FD, ms[(2, 2)], ("stream",)))
    assert st.holders == (0, 2)
    want = st.gather()
    on4 = st.reshard(ms[(4, 1)], ("stream",))
    back = on4.reshard(ms[(2, 2)], ("stream",), holders=(0, 2))
    assert on4.holders == (0, 1, 2, 3) and back.holders == (0, 2)
    assert_tree_equal(want, on4.gather(), "4 x 1")
    assert_tree_equal(want, back.gather(), "2 x 2 again")
    frames = torch.from_numpy(BATCH[:, 2:4])
    st1, m1 = tmesh.run_video_batch_shardmap(algo, frames, ms[(4, 1)], states=st)
    st2, m2 = tmesh.run_video_batch_shardmap(algo, frames, ms[(4, 1)], states=want)
    assert torch.equal(m1, m2) and int((m1 > 0).sum()) > 0
    assert_tree_equal(st2, st1.gather())


def _fd_states():
    algo = t_get("FrameDifferenceBGS")()
    return stack_states([algo.warm_start(algo.init(32, 48, 3, device="cpu"), f[0]) for f in torch.from_numpy(BATCH)])


STATES_FD = _fd_states()
