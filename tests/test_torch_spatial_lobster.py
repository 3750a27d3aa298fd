"""Row sharding of LOBSTER and of SuBSENSE's consensus v3 in 8 shards of 8
rows (``tracking_tpu_torch.parallel.spatial.run_video_spatial``) against the
JAX package's ``run_video_spatial`` on the 8-device CPU mesh and the port's
unsharded run, masks and every state leaf bit for bit; and the plain
LOBSTER consensus's slab mode (``consensus_lobster_ref(row_ext=E)``) on
halo slabs built by the shard group, against the unsharded rows, with a
halo of one neighbour (E = 8) and of three (E = 24 > h_loc = 8, the JAX
kernel's ``row_ext`` in ``tests/test_mesh.py::test_spatial_pallas_kernel_exact``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_spatial_path import _spatial_stream
from torch_parity import assert_tree_equal
from tracking_tpu.core.registry import get_algorithm as j_get
from tracking_tpu_torch import get_algorithm as t_get
from tracking_tpu_torch.parallel.mesh import ShardGroup
from tracking_tpu_torch.parallel.spatial import SpatialCtx, run_video_spatial
from tracking_tpu_torch.runner.scan import run_video

FRAMES = _spatial_stream(64, 48)


@pytest.mark.parametrize("name,env", [("LOBSTERBGS", {}), ("SuBSENSEBGS", {"TRACKING_TPU_CONSENSUS": "v3"})],
                         ids=["lobster", "subsense-v3"])
def test_eight_shards_match_jax(monkeypatch, name, env):
    from tracking_tpu.parallel.mesh import make_mesh
    from tracking_tpu.parallel.spatial import run_video_spatial as j_run_spatial

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j_state, j_masks = j_run_spatial(j_get(name)(), jnp.asarray(FRAMES), make_mesh(8, stream=1))
    state, masks = run_video_spatial(t_get(name)(), torch.from_numpy(FRAMES), n_shards=8)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(j_masks))
    assert int((masks > 0).sum()) > 0
    assert_tree_equal(jax.device_get(j_state), state)
    u_state, u_masks = run_video(t_get(name)(), torch.from_numpy(FRAMES))
    assert torch.equal(masks, u_masks)
    assert_tree_equal(u_state, state)


@pytest.mark.parametrize("E", [8, 24])
@pytest.mark.parametrize("c", [3, 1])
def test_lobster_slab_mode_equals_the_unsharded_rows(E, c):
    """LOBSTER after 3 frames, a random 3×3 pending log (self writes inside
    the ROI only, as a step logs them: the slab's own rows carry the ROI
    clamp of the pending values, the kernel's contract): each of 8 ranks
    builds its planes' slab with ``extend_plain`` and its pending values'
    with ``extend_border`` (E rows, from as many neighbours as E spans) and
    runs the plain consensus's slab mode; every output equals the rows of
    the unsharded call."""
    from tracking_tpu_torch.ops.consensus import consensus_lobster_ref, nb3_to_nb5_idx, pack_pending_ctrl, roi_map

    algo = t_get("LOBSTERBGS")()
    frames = torch.from_numpy(FRAMES if c == 3 else FRAMES[..., 1].copy())
    st, _ = run_video(algo, frames[:4])
    h, w = frames.shape[1:3]
    gen = torch.Generator().manual_seed(4)

    def rnd(hi):
        return torch.randint(0, hi, (h, w), generator=gen, dtype=torch.int32)

    zero = torch.zeros((h, w), dtype=torch.int32)
    roi = roi_map(h, w).to(torch.int32)
    ctrl = pack_pending_ctrl(rnd(2) & roi, rnd(35), nb3_to_nb5_idx(rnd(8)), zero, rnd(35), zero)
    vals = tuple(v | (rnd(2) << 24) if i == 0 else v for i, v in enumerate(st["pend_vals"]))
    planes = tuple(frames[4][..., i].contiguous() for i in range(c)) if c == 3 else (frames[4],)
    kw = algo._kernel_kw(c)
    full = consensus_lobster_ref(planes, st["colors"], st["descs"], ctrl, vals, **kw)
    n = 8
    hl = h // n

    def rank_fn(rank, comm):
        ctx = SpatialCtx(comm, h)
        r0 = rank * hl

        def own(x):
            return x[..., r0 : r0 + hl, :].contiguous()

        return consensus_lobster_ref(
            tuple(ctx.extend_plain(own(p), halo=E) for p in planes), tuple(map(own, st["colors"])),
            tuple(map(own, st["descs"])), own(ctrl), tuple(ctx.extend_border(own(v), halo=E) for v in vals),
            **kw, row_ext=E,
        )

    out = ShardGroup(n).run(rank_fn)
    for k, name in enumerate(("count", "intra", "bg_sum", "colors", "descs")):
        got = [o[k] for o in out]
        if isinstance(full[k], tuple):
            for ci in range(c):
                assert torch.equal(torch.cat([g[ci] for g in got], dim=-2), full[k][ci]), (name, ci)
        else:
            assert torch.equal(torch.cat(got, dim=-2), full[k]), name
    assert int((full[0] < kw["req"]).sum()) > 0  # some pixels are short of the required samples
