"""The port's row sharding (``tracking_tpu_torch.parallel``) piece by piece:
``ShardGroup``'s collectives and failure handling, the halo builders, and
the sharded labelling, blob table, fill, post-processing, mean-shift and
refresh against the JAX package's ``shard_map`` versions on the 8-device
CPU mesh (or its unsharded functions), exact."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from torch_parity import assert_tree_equal, to_torch
from tracking_tpu.ops import cc as jcc
from tracking_tpu.parallel import spatial as jsp
from tracking_tpu.parallel.mesh import make_mesh, shard_map
from tracking_tpu_torch.ops import cc as tcc
from tracking_tpu_torch.parallel import spatial as tsp
from tracking_tpu_torch.parallel.mesh import ShardGroup

N8 = 8


def _port(n, H, fn, *global_tensors):
    """``fn(ctx, *own rows)`` on ``n`` ranks of a ShardGroup; per-rank results."""
    h = H // n
    shards = [[t[r * h : (r + 1) * h].contiguous() for r in range(n)] for t in global_tensors]

    def body(rank, comm, *own):
        return fn(tsp.SpatialCtx(comm, H, device=own[0].device), *own)

    return ShardGroup(n).run(body, *shards)


def _jax(H, fn, *global_arrays, in_specs=None, out_specs=P("space", None)):
    """``fn(ctx, *shards)`` under shard_map on the 8-device CPU mesh."""
    if len(jax.devices()) < N8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = make_mesh(N8, stream=1)
    in_specs = in_specs or (P("space", None),) * len(global_arrays)
    f = shard_map(
        lambda *a: fn(jsp.SpatialCtx("space", N8, H), *a),
        mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_rep=False,
    )
    args = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)) for a, s in zip(global_arrays, in_specs)]
    return jax.jit(f)(*args)


# -- ShardGroup ---------------------------------------------------------------------


@pytest.mark.parametrize("shift", [1, -1, 2])
def test_ppermute_zero_fills(shift):
    n = 4

    def body(rank, comm, x):
        return comm.ppermute(x, shift)

    out = ShardGroup(n).run(body, [torch.full((2, 3), r + 1, dtype=torch.int32) for r in range(n)])
    for r, got in enumerate(out):
        src = r - shift
        want = src + 1 if 0 <= src < n else 0
        assert torch.equal(got, torch.full((2, 3), want, dtype=torch.int32)), (r, got)


def test_reductions_in_rank_order():
    """psum adds in rank order 0..n-1 (here f32 cancellation shows it),
    pmax and all_gather likewise; a receiver never sees the sender's later
    in-place writes."""
    vals = np.array([1e8, 1.0, -1e8, 1.0], np.float32)
    want = np.float32(0)
    for v in vals:
        want = np.float32(want + v)

    def body(rank, comm, x):
        s = comm.psum(x)
        m = comm.pmax(x)
        g = comm.all_gather(x[None], dim=0)
        x.fill_(-7.0)  # after sending: must not reach the others' results
        return s, m, g

    out = ShardGroup(4).run(body, [torch.tensor([v], dtype=torch.float32) for v in vals])
    for s, m, g in out:
        assert s.item() == want == 1.0
        assert m.item() == 1e8
        assert torch.equal(g, torch.from_numpy(vals)[:, None])


def test_a_raising_rank_fails_the_run():
    def body(rank, comm, x):
        if rank == 2:
            raise ValueError("rank 2 is broken")
        return comm.psum(x)

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 2 is broken"):
        ShardGroup(4, timeout=60.0).run(body, [torch.ones(1)] * 4)
    assert time.perf_counter() - t0 < 30.0


def test_a_missing_rank_times_out():
    def body(rank, comm, x):
        return x if rank == 1 else comm.psum(x)  # rank 1 skips the collective

    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        ShardGroup(3, timeout=1.0).run(body, [torch.ones(1)] * 3)
    assert time.perf_counter() - t0 < 30.0
    assert threading.active_count() < 8  # every rank thread has ended


def test_stress_more_ranks_than_cores():
    """16 ranks, a thread switch every microsecond: 200 rounds of psum and
    ppermute keep every rank's running values equal to the serial result,
    and the launch counter loses no update."""
    import sys

    from tracking_tpu_torch.ops import _native

    n, rounds = 16, 200

    mod = 1_000_003

    def body(rank, comm, x):
        for _ in range(rounds):
            x = (comm.psum(x) - comm.ppermute(x, 1)) % mod
            _native.count_launch("label_fixpoint")
        return x

    want = list(range(n))
    for _ in range(rounds):
        total = sum(want)
        want = [(total - (want[r - 1] if r else 0)) % mod for r in range(n)]
    saved = sys.getswitchinterval()
    _native.reset_launches()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        got = ShardGroup(n, timeout=60.0).run(body, [torch.tensor([r]) for r in range(n)])
    finally:
        sys.setswitchinterval(saved)
    assert time.perf_counter() - t0 < 60.0
    assert [int(g) for g in got] == want
    assert _native.LAUNCHES["label_fixpoint"] == n * rounds
    _native.reset_launches()


@pytest.mark.parametrize("n,halo", [(4, 3), (8, 5), (8, 9)], ids=["one-hop", "multi-hop", "halo-past-both-edges"])
def test_halo_builders(n, halo):
    """extend_plain / extend_border / extend_const / clamp_rows against
    direct indexing of the global array, with halos up to more than h_loc
    (several hops) and past the image edges."""
    H, W = 16, 5
    g = torch.arange(H * W, dtype=torch.int32).reshape(H, W)

    def body(ctx, own):
        ext = ctx._extend(own, halo)
        return (ctx.extend_plain(own, halo), ctx.extend_border(own, halo=halo), ctx.extend_const(own, halo, -1),
                ctx.clamp_rows(ext, halo), ctx.crop(ctx.extend_plain(own, halo), halo))

    for r, (plain, border, const, clamped, crop) in enumerate(_port(n, H, body, g)):
        rows = torch.arange(r * (H // n) - halo, (r + 1) * (H // n) + halo)
        assert torch.equal(plain, g[rows.clamp(0, H - 1)])
        assert torch.equal(clamped, plain)
        assert torch.equal(border, g[rows.clamp(2, H - 3)])
        out = (rows < 0) | (rows >= H)
        assert torch.equal(const, torch.where(out[:, None], -1, g[rows.clamp(0, H - 1)]))
        assert torch.equal(crop, g[r * (H // n) : (r + 1) * (H // n)])


# -- sharded labelling, blobs, fill, post-processing --------------------------------


def _blob_mask():
    """tests/test_mesh.py:173's mask: blocky components, one blob across all
    8 cuts, and a diagonal-only chain across the cut at y = 8."""
    H, W = 64, 48
    rng = np.random.default_rng(11)
    coarse = rng.random((8, 6)) < 0.3
    mask = np.kron(coarse, np.ones((8, 8), bool)).astype(np.uint8) * 255
    mask[4:62, 20:23] = 255
    mask[7, 0], mask[8, 1], mask[9, 0] = 255, 255, 255
    return mask


def test_sharded_label_and_blobs_exact():
    mask = _blob_mask()
    H = mask.shape[0]
    got = _port(N8, H, lambda ctx, m: (tsp.sharded_label(ctx, m), tsp.sharded_extract_blobs(ctx, m)),
                torch.from_numpy(mask))
    lab = torch.cat([g[0] for g in got])
    j_lab, j_blobs = _jax(H, lambda ctx, m: (jsp.sharded_label(ctx, m), jsp.sharded_extract_blobs(ctx, m)),
                          mask, out_specs=(P("space", None), P()))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(j_lab))
    np.testing.assert_array_equal(lab.numpy(), tcc.label_components(torch.from_numpy(mask)).numpy())
    want = jax.device_get(j_blobs)._asdict()
    for g in got:  # the same table on every rank
        assert_tree_equal(want, g[1]._asdict())
    assert_tree_equal(jax.device_get(jcc.extract_blobs(jnp.asarray(mask)))._asdict(),
                      tcc.extract_blobs(torch.from_numpy(mask))._asdict())
    assert_tree_equal(want, tcc.extract_blobs(torch.from_numpy(mask))._asdict())


def _fill_mask():
    """Holes cut by several shard borders and a background serpentine that
    crosses the cuts back and forth (several injection rounds)."""
    H, W = 64, 48
    m = np.zeros((H, W), np.uint8)
    m[3:61, 3:45] = 255
    m[10:30, 10:20] = 0  # a hole across the cuts at 16 and 24
    for k, y in enumerate(range(36, 58, 4)):  # serpentine channel from the left edge
        m[y, 4:40] = 0
        x = 39 if k % 2 == 0 else 4
        m[y : y + 5, x] = 0
    m[36, 0:5] = 0  # its mouth
    m[40:44, 30:34] = 0  # a hole near it
    return m


@pytest.mark.parametrize("which", ["fill", "blobs-4conn"])
def test_sharded_fill_and_4conn_label_exact(which):
    mask = _fill_mask()
    H = mask.shape[0]
    if which == "fill":
        got = torch.cat(_port(N8, H, tsp.sharded_fill, torch.from_numpy(mask)))
        want = _jax(H, jsp.sharded_fill, mask)
    else:
        got = torch.cat(_port(N8, H, lambda ctx, m: tsp.sharded_label(ctx, m, 4), torch.from_numpy(mask)))
        want = _jax(H, lambda ctx, m: jsp.sharded_label(ctx, m, 4), mask)
        np.testing.assert_array_equal(got.numpy(), tcc.label_components(torch.from_numpy(mask), 4).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ksize", [3, 9])
def test_sharded_postproc_exact(ksize):
    mask = _fill_mask()
    rng = np.random.default_rng(4)
    raw = np.where(rng.random(mask.shape) < 0.08, 255, mask).astype(np.uint8)
    raw[0, 10:20] = raw[-1, 5:9] = 255  # the image's edge rows
    is_fg = raw > 0
    H = raw.shape[0]
    got = _port(N8, H, lambda ctx, r, f: tsp.sharded_postproc(ctx, r, f, ksize),
                torch.from_numpy(raw), torch.from_numpy(is_fg))
    j_final, j_inv = _jax(H, lambda ctx, r, f: jsp.sharded_postproc(ctx, r, f, ksize), raw, is_fg,
                          out_specs=(P("space", None), P("space", None)))
    np.testing.assert_array_equal(torch.cat([g[0] for g in got]).numpy(), np.asarray(j_final))
    np.testing.assert_array_equal(torch.cat([g[1] for g in got]).numpy(), np.asarray(j_inv))


def test_sharded_meanshift_exact():
    from tracking_tpu.track import meanshift as jms
    from tracking_tpu_torch.track import meanshift as tms

    H, W, K = 64, 48, 6
    rng = np.random.default_rng(9)
    weight = (rng.random((H, W)) < 0.3).astype(np.float32)
    weight[20:40, 10:30] = 1.0
    cys = np.array([2.0, 15.5, 30.0, 47.9, 63.0, 33.3], np.float32)
    cxs = np.array([1.0, 20.0, 24.5, 40.0, 47.0, 5.0], np.float32)
    got = _port(N8, H, lambda ctx, w_: tms.meanshift_refine_batch_sharded(ctx, w_, torch.from_numpy(cys),
                                                                         torch.from_numpy(cxs)),
                torch.from_numpy(weight))
    want = _jax(H, lambda ctx, w_, y, x: jms.meanshift_refine_batch_sharded(ctx, w_, y, x), weight, cys, cxs,
                in_specs=(P("space", None), P(), P()), out_specs=(P(), P(), P()))
    unsharded = tms.meanshift_refine_batch(torch.from_numpy(weight), torch.from_numpy(cys), torch.from_numpy(cxs))
    for g in got:
        for a, b, c in zip(g, want, unsharded):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(a.numpy(), c.numpy())


def test_sharded_refresh_samples_exact():
    """tests/test_mesh.py:234's inputs: the refresh of each rank's rows (the
    sources read from border-extended slabs, the global offset draw
    row-sliced) equals the JAX package's unsharded refresh."""
    from tracking_tpu.bgs.lbsp_family import _refresh_samples as j_refresh
    from tracking_tpu_torch.bgs.lbsp_family import _refresh_samples as t_refresh
    from tracking_tpu_torch.ops import rng as trng

    H, W, C, N = 64, 48, 3, 10
    rng = np.random.default_rng(5)
    key = jax.random.PRNGKey(42)
    planes = tuple(rng.integers(0, 256, (H, W), np.uint8) for _ in range(C))
    intra = tuple(rng.integers(0, 1 << 16, (H, W)).astype(np.uint16) for _ in range(C))
    ok = rng.random((H, W)) < 0.7
    colors = tuple(rng.integers(0, 256, (N, H, W), np.uint8) for _ in range(C))
    descs = tuple(rng.integers(0, 1 << 16, (N, H, W)).astype(np.uint16) for _ in range(C))
    start = jnp.asarray(3, jnp.int32)
    want_c, want_d = jax.jit(
        lambda co, de: j_refresh(key, N, 2, start, tuple(map(jnp.asarray, planes)), tuple(map(jnp.asarray, intra)),
                                 jnp.asarray(ok), co, de)
    )(tuple(map(jnp.asarray, colors)), tuple(map(jnp.asarray, descs)))

    tkey = trng.prng_key(42)
    state = to_torch({"colors": colors, "descs": descs, "planes": planes, "intra": intra, "ok": ok})
    specs = tsp.spatial_specs(state, H)
    shards = tsp.shard_state(state, specs, N8)

    def body(rank, comm, st):
        ctx = tsp.SpatialCtx(comm, H)
        return t_refresh(tkey, N, 2, torch.tensor(3, dtype=torch.int32), st["planes"], st["intra"], st["ok"],
                         st["colors"], st["descs"], ctx=ctx)

    out = ShardGroup(N8).run(body, shards)
    got = tsp.gather_state([{"colors": o[0], "descs": o[1]} for o in out], {"colors": specs["colors"],
                                                                           "descs": specs["descs"]})
    assert_tree_equal({"colors": jax.device_get(want_c), "descs": jax.device_get(want_d)}, got)


def test_state_split_and_join_round_trip():
    """shard_state / gather_state: leaves with H rows split and join back;
    others (here a [8, 48] map whose rows equal h_loc) are replicated."""
    H = 64
    state = {"a": torch.arange(3 * H * 5).reshape(3, H, 5), "b": (torch.ones(H, 2), torch.zeros(8, 48)),
             "t": torch.tensor(4)}
    specs = tsp.spatial_specs(state, H)
    assert specs == {"a": True, "b": (True, False), "t": False}
    shards = tsp.shard_state(state, specs, N8)
    assert shards[3]["a"].shape == (3, 8, 5) and shards[3]["b"][1].shape == (8, 48)
    assert_tree_equal(state, tsp.gather_state(shards, specs))
