"""A 2-D run (2 streams × 2 row shards of 144 rows) in which one stream row
takes SuBSENSE's auto-reset refresh and the other does not: the refresh's
halo exchanges run in one row only, so the rows call different numbers of
collectives. Each row synchronises on its own, so the run finishes, and
each stream equals its own unsharded run (which
``tests/test_torch_subsense_scaling.py`` pins to the JAX package)."""

import torch

from torch_parity import assert_tree_equal
from tracking_tpu_torch.bgs.lbsp_family import SuBSENSE
from tracking_tpu_torch.convert import split_states, stack_states
from tracking_tpu_torch.parallel.mesh import make_mesh, run_video_batch
from tracking_tpu_torch.runner.scan import run_video
from tracking_tpu_torch.synth import make_clip

H, W = 288, 544


def test_one_row_resets_the_other_does_not():
    algo = SuBSENSE()
    jump = torch.from_numpy(make_clip(4, H, W, 3, seed=5, brightness_jump=(3, 45)))
    quiet = torch.from_numpy(make_clip(4, H, W, 3, seed=6))
    # test_torch_spatial_path.py's mid-stream state: long- and short-term
    # means 120 apart, so frame 1 triggers the refresh
    st0 = algo.warm_start(algo.init(H, W, 3, device="cpu"), jump[0])
    st0 = dict(st0, t=torch.tensor(100, dtype=torch.int32), ds_lt=tuple(torch.zeros_like(d) for d in st0["ds_lt"]),
               ds_st=tuple(torch.full_like(d, 120.0) for d in st0["ds_st"]))
    st1 = algo.warm_start(algo.init(H, W, 3, device="cpu"), quiet[0])
    frames = torch.stack([jump[1:], quiet[1:]])
    got_states, got = run_video_batch(algo, frames, states=stack_states([st0, st1]),
                                      mesh=make_mesh(4, stream=2, device="cpu"))
    for b, st in enumerate((st0, st1)):
        want_state, want = run_video(algo, frames[b], state=st)
        assert torch.equal(got[b], want), f"stream {b}"
        assert_tree_equal(want_state, split_states(got_states, 2)[b], f"stream {b}")
    cooldown = got_states["cooldown"].tolist()
    assert cooldown == [25 - 3, 0]  # stream 0 triggered at frame 1, stream 1 never
