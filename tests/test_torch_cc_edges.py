"""The port's plain CC labelling (``label_components_ref``, the version the
card holds the CUDA kernel against) on the masks that break union-find
designs over 32-px tiles (``torch_parity.edge_mask``), 8- and 4-connected,
against a BFS labeller, JAX's ``label_components`` and
``label_components_pallas`` in interpret mode (each case converges inside
its 64-round cap at this size), exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import CC_CASES, component_min, edge_mask
from tracking_tpu.ops import cc as jcc
from tracking_tpu.ops.pallas_cc import label_components_pallas
from tracking_tpu_torch.ops import cc as tcc


def _bfs_labels(fg, conn):
    """Each component's minimum row-major index, -1 on background."""
    n = fg.size
    lab = component_min(fg, np.arange(n, dtype=np.int32).reshape(fg.shape), n, conn)
    return np.where(fg, lab, -1)


@pytest.mark.parametrize("case", CC_CASES)
@pytest.mark.parametrize("connectivity", [8, 4])
def test_label_components_ref_on_edge_masks(case, connectivity):
    fg = edge_mask(case)
    m = (fg * 255).astype(np.uint8)
    got = tcc.label_components_ref(torch.from_numpy(m), connectivity).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _bfs_labels(fg, connectivity))
    np.testing.assert_array_equal(got, np.asarray(jcc.label_components(jnp.asarray(m), connectivity)))
    np.testing.assert_array_equal(
        got, np.asarray(label_components_pallas(jnp.asarray(m), connectivity=connectivity, interpret=True))
    )
    n_comp = int((got.reshape(-1) == np.arange(got.size)).sum())
    if case == "checkerboard":  # one component 8-connected, singletons 4-connected
        assert n_comp == (1 if connectivity == 8 else int(fg.sum()))
    if case == "serpentine":
        assert n_comp == 1
