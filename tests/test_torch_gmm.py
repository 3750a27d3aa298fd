"""MixtureOfGaussianV1BGS (type 4, the tracking app's ``--fg FG_1``) in the
port against the JAX package: both packages' ``run_video`` over seeded
clips, colour and grey, with the mask, the background image and every
state leaf (w, var, mu, n, t) compared bit for bit after every frame.

The float state is exact: the port divides a tensor by a tensor where the
reference does (``alpha / max(w, eps)`` is a constant over a tensor), sums
in the reference's index order, builds no ``addcmul`` or ``lerp`` and takes
correctly rounded square roots (torch's CPU ``sqrt`` is not).
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal, run_both
from tracking_tpu.bgs import gmm as JM
from tracking_tpu_torch import get_algorithm
from tracking_tpu_torch.bgs import gmm as TM
from tracking_tpu_torch.synth import make_clip


def test_registry_names():
    for key in (4, "mog1", "mog", "MixtureOfGaussianV1BGS"):
        assert get_algorithm(key) is TM.MixtureOfGaussianV1


@pytest.mark.parametrize("c,seed,noise", [(3, 0, 2.5), (1, 3, 2.5), (3, 5, 6.0)])
def test_mog1_matches_reference(c, seed, noise):
    """14 frames at 40x56: modes are born, matched, reordered and replaced
    (noise 6 keeps the mixture full). Frame 1 is all foreground (every
    pixel opens its first mode); from frame 2 on the foreground share is
    checked to be neither empty nor everything."""
    frames = make_clip(14, 40, 56, c, seed=seed, noise=noise)
    shares, st = run_both(JM.MixtureOfGaussianV1(), TM.MixtureOfGaussianV1(), frames)
    assert shares[0] == 1.0 and 0.0 < max(shares[1:]) < 0.9
    assert int(st["n"].max()) >= 2  # more than one mode in use


def test_sort_is_stable_on_ties():
    """The odd-even network keeps equal keys in their order (it swaps only
    on a strict ``<``), as the reference's does; -inf keys sink."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    keys = rng.choice([-np.inf, 0.5, 1.0, 2.0], size=(5, 6, 7)).astype(np.float32)
    pay = np.arange(5 * 6 * 7, dtype=np.float32).reshape(5, 6, 7)
    jk, (jp,) = JM._sort_desc_maps([jnp.asarray(k) for k in keys], [[jnp.asarray(p) for p in pay]])
    tk, (tp,) = TM._sort_desc_maps([torch.from_numpy(k) for k in keys], [[torch.from_numpy(p) for p in pay]])
    assert_tree_equal(tuple(np.asarray(x) for x in jk + jp), tuple(tk + tp))
