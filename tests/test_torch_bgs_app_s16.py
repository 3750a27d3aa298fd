"""The BGS apps with LbpMrf and MultiCue, the port against the JAX
package (the helpers and clip of ``test_torch_bgs_app.py``):
``cdnet_run --bgs lbp-mrf`` and a ``bgs_run`` fan-out of both (XMLs,
stdout, masks and states). The JAX apps run in processes of their own
(``torch_parity.run_jax_child``): the JAX package's exact LbpMrf step may
be compiled only once a process."""

import os

import numpy as np
import torch

from test_torch_bgs_app import T, _fanout_config, cdnet_both, frames_dir, run_bgs_apps  # noqa: F401
from torch_parity import run_jax_child


def test_cdnet_lbp_mrf(tmp_path):
    """``cdnet_run --bgs lbp-mrf`` (the exact min cut; the JAX app in a
    process of its own). LbpMrf's first masks are mostly foreground (the
    short-memcpy model init)."""
    cdnet_both(tmp_path, "lbp-mrf", jax_child=True, max_share=1.0)


# the JAX fan-out that a config directory builds, over inp["frames"] in
# chunks of 6, in a process of its own: masks and states after each chunk,
# flattened to "chunk/masks|states/path"
JAX_FANOUT = """
import jax.numpy as jnp
from tracking_tpu.runner.pipeline import FrameProcessor

def flat(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(f"{prefix}/{k}", v)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            flat(f"{prefix}/{i}", v)
    else:
        out[prefix] = np.asarray(tree)

fp = FrameProcessor.from_config_dir(str(inp["cfgdir"]))
frames, st = inp["frames"], None
for a in range(0, frames.shape[0], 6):
    st, masks = fp.run(jnp.asarray(frames[a : a + 6]), st)
    flat(f"{a}/masks", jax.device_get(masks))
    flat(f"{a}/states", jax.device_get(st))
"""


def test_fanout_slice16_algorithms(monkeypatch, tmp_path, frames_dir):
    """A fan-out of LbpMrf (the exact min cut) and MultiCue (its XML edited
    to 5 training frames, capacities of 4 and 3 codewords and a 32x24
    reduced map) with the blur on: the apps' XMLs byte for byte, stdout
    line for line (each scored at ``--stopAt``); then the fan-out that those
    XMLs build, in both packages, in chunks of 6: masks and states bit for
    bit after each chunk. The JAX apps run in processes of their own."""
    from tracking_tpu_torch.bgs.multicue import MultiCueConfig
    from tracking_tpu_torch.core.config import config_to_xml
    from tracking_tpu_torch.runner.pipeline import FrameProcessor

    d, frames = frames_dir
    names = ["LbpMrf", "SJN_MultiCueBGS"]

    def setup(p):
        # no tictoc: the JAX app's FrameProcessor.profile times every
        # algorithm, which compiles LbpMrf's step a second time
        _fanout_config(p, ("enableLbpMrf", "enableMultiCueBGS"))
        config_to_xml(MultiCueConfig(trainingPeriod=4, modelCapacity=4, cacheCapacity=3, reducedWidth=32,
                                     reducedHeight=24), os.path.join(p, "config", "SJN_MultiCueBGS.xml"))

    out = run_bgs_apps(
        monkeypatch, tmp_path,
        ["--frames_dir", str(d), "--chunk", "6", "--compare", "--imgref", str(d / "ref.png"), "--stopAt", "11"],
        setup=setup, files=[f"config/{n}.xml" for n in ["FrameProcessor", "PreProcessor"] + names], jax_child=True,
    )
    assert [line.split(" frame ")[0] for line in out[:2]] == sorted(names)
    assert out[-1].startswith("+".join(names) + f": {T} frames in ")  # the flags' order

    cfgdir = str(tmp_path / "torch" / "config")
    ref = run_jax_child(JAX_FANOUT, tmp_path, cfgdir=np.array(cfgdir), frames=frames)
    fp = FrameProcessor.from_config_dir(cfgdir)
    assert list(fp.algorithms) == names
    st = None
    for a in range(0, T, 6):
        st, masks = fp.run(torch.from_numpy(frames[a : a + 6]), st)
        for kind, tree in (("masks", masks), ("states", st)):
            got = {}

            def flat(prefix, t):
                if isinstance(t, dict):
                    for k, v in t.items():
                        flat(f"{prefix}/{k}", v)
                else:
                    got[prefix] = t.numpy()

            flat(f"{a}/{kind}", tree)
            want = {k: v for k, v in ref.items() if k.startswith(f"{a}/{kind}/")}
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(float((masks[n] > 0).float().mean()) > 0.0 for n in names)
