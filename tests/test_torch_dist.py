"""The process group of the port (``tracking_tpu_torch.parallel.dist``) on
the CPU: gloo ranks in spawned processes against the thread group's
``ShardComm`` (``parallel/mesh.py``), which ``tests/test_torch_mesh.py``
and the spatial tests hold to JAX's collectives. ``ppermute`` zero-fills
both ends and crosses several hops, ``psum`` sums floats in rank order
(the bits of a ring order differ), ``pmax``, ``all_gather``, the axis
groups of a 2 × 2 mesh whose rows run different numbers of collectives; a
rank that raises, or a collective that waits past its timeout, fails the
call; algorithms, trackers and the consensus switches reach the ranks
whole; the ranks import neither JAX nor the JAX package; and the mesh's
backends. The rank functions live in ``tests/dist_ranks.py``."""

import pickle
import time

import pytest
import torch

import dist_ranks
from torch_parity import assert_tree_equal
from tracking_tpu.parallel import mesh as jmesh
from tracking_tpu_torch import get_algorithm as t_get
from tracking_tpu_torch.parallel.dist import DistGroup
from tracking_tpu_torch.parallel.mesh import ShardGroup, make_mesh
from tracking_tpu_torch.track.tracker import BlobTracker


@pytest.fixture(scope="module")
def groups():
    """Process groups of 2 and 4 ranks on the CPU, ended with the module."""
    made = {n: DistGroup(n, "gloo", ["cpu"] * n, timeout=60.0) for n in (2, 4)}
    yield made
    for g in made.values():
        g.close()


def both(groups, n, fn, *args, axes=None):
    """``fn`` on the process group of ``n`` ranks and on a thread group of
    the same layout: (processes' results, threads' results)."""
    threads = ShardGroup(n, timeout=60.0, axes=axes or {"space": n})
    return groups[n].run(fn, *args, axes=axes), threads.run(fn, *args)


def per_rank(n, make):
    return [make(r) for r in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_ppermute_zero_fills_and_crosses_hops(groups, n):
    """Shifts of ±1 and of several hops (as ``SpatialCtx._halo_band``'s),
    on f32, bool, u8 and 0-d tensors: what rank r − shift sent, zeros of
    the sender's dtype and shape where it does not exist."""
    hops = [1, -1, 2, -2, n - 1, -(n - 1), n]
    xs = per_rank(n, lambda r: (torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * r,
                                torch.tensor([r % 2 == 0, True, False]), torch.full((2, 2), r + 1, dtype=torch.uint8),
                                torch.tensor(r + 5, dtype=torch.int32)))
    for k in range(4):
        got, want = both(groups, n, dist_ranks.shifts, [x[k] for x in xs], [hops] * n)
        for r in range(n):
            for h, g, w in zip(hops, got[r], want[r]):
                src = r - h
                expect = xs[src][k] if 0 <= src < n else torch.zeros_like(xs[r][k])
                assert g.dtype == expect.dtype and g.shape == expect.shape
                assert torch.equal(g, expect) and torch.equal(g, w), (r, h, k)


def test_psum_sums_floats_in_rank_order(groups):
    """1e8, 1, −1e8, 1 in f32: rank order gives 1 (the first 1 is lost
    against 1e8), a pairing of 1e8 with −1e8 first would give 2."""
    vals = [1e8, 1.0, -1e8, 1.0]
    xs = per_rank(4, lambda r: torch.tensor([vals[r], vals[(r + 1) % 4]], dtype=torch.float32))
    got, want = both(groups, 4, dist_ranks.reduce_all, xs)
    seq = xs[0].clone()
    for x in xs[1:]:
        seq = seq + x
    assert seq.tolist() == [1.0, 0.0]
    for r in range(4):
        assert torch.equal(got[r][0], seq) and torch.equal(got[r][0], want[r][0])


def test_pmax_and_all_gather_in_rank_order(groups):
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randint(-50, 50, (3, 2), generator=gen, dtype=torch.int32) for _ in range(4)]
    got, want = both(groups, 4, dist_ranks.reduce_all, xs)
    for r in range(4):
        assert torch.equal(got[r][1], torch.stack(xs).amax(dim=0))
        assert torch.equal(got[r][2], torch.cat(xs)) and torch.equal(got[r][3], torch.cat([x[None] for x in xs], 1))
        for g, w in zip(got[r], want[r]):
            assert torch.equal(g, w)


def test_axis_groups_let_rows_run_apart(groups):
    """The 4 ranks as a 2 × 2 mesh: sums over a rank's ``space`` group see
    its stream row only, over its ``stream`` group its column; row 1 runs
    three more row sums than row 0 without a deadlock. Then as 4 × 1 and
    1 × 4: one group of processes serves every layout."""
    xs = [torch.tensor([float(r)]) for r in range(4)]
    for axes in ({"stream": 4, "space": 1}, {"stream": 1, "space": 4}):
        got, want = both(groups, 4, dist_ranks.rows_and_columns, xs, axes=axes)
        for r, (g, w) in enumerate(zip(got, want)):
            assert g[0] == w[0] and float(g[4]) == 6.0
            assert_tree_equal(w[1:], g[1:])
    got, want = both(groups, 4, dist_ranks.rows_and_columns, xs, axes={"stream": 2, "space": 2})
    for r, (g, w) in enumerate(zip(got, want)):
        i, j = divmod(r, 2)
        assert g[0] == (j, 2, i, 2)
        assert float(g[1]) == 4 * i + 1 and g[2].tolist() == [2.0 * i, 2.0 * i + 1]
        assert float(g[3]) == 2 + 2 * j and float(g[4]) == 6.0
        assert_tree_equal(w[1:], g[1:])


def test_a_raising_rank_fails_the_call():
    """Rank 1 raises while rank 0 waits in a sum: the call raises rank 1's
    error at once, with its traceback, and the workers are gone."""
    group = DistGroup(2, "gloo", ["cpu"] * 2, timeout=60.0)
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 1 fails") as info:
        group.run(dist_ranks.fail_on, [1, 1])
    assert time.perf_counter() - t0 < 30.0
    assert any("in rank 1" in note for note in info.value.__notes__)
    assert group.closed and not any(p.is_alive() for p in group._procs)
    with pytest.raises(RuntimeError, match="closed"):
        group.run(dist_ranks.fail_on, [-1, -1])


def test_a_collective_past_its_timeout_fails_the_call():
    """Rank 1 comes 20 s late to a sum whose timeout is 2 s: rank 0's
    collective raises, and so does the call, well before rank 1 arrives."""
    group = DistGroup(2, "gloo", ["cpu"] * 2, timeout=2.0)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError):
        group.run(dist_ranks.late_on, [1, 1], [20.0, 20.0])
    assert time.perf_counter() - t0 < 15.0
    assert group.closed


def _objects():
    return [t_get("SuBSENSEBGS")(nBGSamples=20, fRelLBSPThreshold=0.25), t_get("LOBSTERBGS")(nRequiredBGSamples=1),
            BlobTracker(trackerType="CC", minBlobArea=10), BlobTracker(trackerType="CCMSPF", maxLostFrames=5)]


@pytest.mark.parametrize("env", [{}, {"TRACKING_TPU_CONSENSUS": "v3"}, {"TRACKING_TPU_FUSED": "1"}],
                         ids=["v1", "v3", "fused"])
def test_algorithms_and_switches_reach_the_ranks(groups, monkeypatch, env):
    """SuBSENSE, LOBSTER and the CC and CCMSPF trackers with their configs
    survive pickle, in this process and in every rank, and each call
    carries the consensus switch the caller set (and drops one it
    unset)."""
    switches = ("TRACKING_TPU_CONSENSUS", "TRACKING_TPU_FUSED")
    for k in switches:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    objs = _objects()
    for o in objs:
        back = pickle.loads(pickle.dumps(o))
        assert type(back) is type(o) and back.config == o.config
    for rep in groups[4].run(dist_ranks.report, [objs] * 4):
        assert rep["objs"] == [(type(o).__name__, o.config) for o in objs]
        assert {k: v for k, v in rep["env"].items() if k in switches} == env
        assert rep["v3"] == ("TRACKING_TPU_CONSENSUS" in env) and rep["fused"] == ("TRACKING_TPU_FUSED" in env)


def test_ranks_import_no_jax(groups):
    """This process has JAX; a rank that unpickled the port's algorithms
    and trackers has neither JAX nor the JAX package."""
    import sys

    assert "jax" in sys.modules
    for n in (2, 4):
        for rep in groups[n].run(dist_ranks.report, [_objects()] * n):
            assert rep["jax"] == [] and rep["tracking_tpu"] == []


@pytest.mark.parametrize("n,stream", [(4, None), (4, 4), (2, 1), (8, 2)])
def test_make_mesh_with_a_backend_splits_as_jax(n, stream):
    """A gloo mesh splits as JAX's and starts no process until its group
    is asked for; its ranks share the device."""
    want = dict(jmesh.make_mesh(n, stream=stream).shape)
    mesh = make_mesh(n, stream=stream, device="cpu", backend="gloo")
    assert mesh.shape == want and mesh.backend == "gloo"
    assert mesh.devices == (torch.device("cpu"),) * n and mesh._pool is None


def test_make_mesh_refuses_what_it_cannot_carry():
    with pytest.raises(ValueError, match="unknown backend"):
        make_mesh(2, device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="takes no device"):
        make_mesh(2, device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="nccl"):  # no NCCL and no card here
        make_mesh(2, backend="nccl")
    with pytest.raises(ValueError, match="do not split"):
        make_mesh(4, stream=3, device="cpu", backend="gloo")


def test_mesh_close_ends_its_workers():
    """The pool starts at the first ``group()``, is the same one after, and
    ``close`` (here the ``with`` block) ends its processes."""
    with make_mesh(2, stream=1, device="cpu", backend="gloo") as mesh:
        group = mesh.group()
        assert mesh.group() is group and group.start_s > 0.0
        got = group.run(dist_ranks.reduce_all, [torch.ones(2), torch.full((2,), 2.0)])
        assert got[1][0].tolist() == [3.0, 3.0]
        assert group.last["compute_s"] >= 0.0 and set(group.last["launches"]) >= {"consensus", "label_fixpoint"}
        procs = list(group._procs)
    assert group.closed and not any(p.is_alive() for p in procs)
