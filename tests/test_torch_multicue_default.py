"""SJN_MultiCueBGS at its default config (24 model and 12 cache codewords,
a 160x120 reduced map, 21 training frames) in the port against the JAX
package: both packages' ``run_video`` over a seeded 240x320 clip (the
reduced map enlarged 2x), through the end of training and into detection,
the mask and every state leaf compared bit for bit after every frame. Its
own file: the JAX step at the default capacities compiles for ~60 s (its
K(K+1)/2 unrolled compaction selects)."""

from torch_parity import run_both
from tracking_tpu.core.registry import get_algorithm as jget
from tracking_tpu_torch import get_algorithm as tget
from tracking_tpu_torch.synth import make_clip


def test_multicue_default_config():
    frames = make_clip(25, 240, 320, 3, seed=12)
    shares, st = run_both(jget("SJN_MultiCueBGS")(), tget("SJN_MultiCueBGS")(), frames)
    assert not any(shares[:21]) and max(shares[21:]) > 0.0, shares
    assert int(st["t"]) == 25 and int(st["tmodel"]["n"].max()) > 1
