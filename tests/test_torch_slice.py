"""The ported slice end to end against the JAX package: SuBSENSE on a short
synthetic colour clip, its masks fed to the default CCMSPF tracker; masks
and track tables compared bit for bit after every frame (Kalman floats
included, see test_torch_kalman.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import step_both
from tracking_tpu.bgs.lbsp_family import SuBSENSE as JSuBSENSE
from tracking_tpu.runner.scan import run_video as jrun
from tracking_tpu.track.tracker import BlobTracker as JTracker
from tracking_tpu_torch.bgs.lbsp_family import SuBSENSE as TSuBSENSE
from tracking_tpu_torch.track.tracker import BlobTracker as TTracker
from tracking_tpu_torch.synth import make_clip


def test_subsense_then_tracker():
    frames = make_clip(22, 64, 96, 3, seed=11, n_objects=2)
    ja, ta = JSuBSENSE(), TSuBSENSE()
    jb = jax.jit(ja.warm_start)(ja.init(64, 96, 3), jnp.asarray(frames[0]))
    tb = ta.warm_start(ta.init(64, 96, 3, device="cpu"), torch.from_numpy(frames[0]))
    jt, tt = JTracker(), TTracker()
    js, ts = jt.init(), tt.init(device="cpu")
    jstep = jax.jit(jt.step)
    births = 0
    for t in range(1, frames.shape[0]):
        jb, jm = jrun(ja, jnp.asarray(frames[t : t + 1]), state=jb)
        tb, fg, _ = ta.step(tb, torch.from_numpy(frames[t]))
        np.testing.assert_array_equal(fg.numpy(), np.asarray(jm[0]), err_msg=f"mask, frame {t}")
        js, ts, jtr = step_both(jstep, tt, js, ts, np.asarray(jm[0]))
        births = int(ts["next_id"])
    assert births >= 1  # tracks were confirmed from the BGS masks
