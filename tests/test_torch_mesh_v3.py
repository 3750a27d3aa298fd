"""SuBSENSE's consensus v3 (``TRACKING_TPU_CONSENSUS=v3``: the read-only
walk, eager slot writes, ``bg_sum`` row-sharded) through ``run_video_batch``
on a 2-D mesh (4 streams × 2 row shards) against the JAX package's and the
port's unsharded runs, bit for bit."""

import pytest
import torch

from test_torch_mesh import BATCH, _check
from test_torch_mesh_spatial import run_2d, unsharded
from torch_parity import assert_tree_equal


def test_v3_stream_by_space_matches_jax(monkeypatch):
    monkeypatch.setenv("TRACKING_TPU_CONSENSUS", "v3")
    want, got = run_2d(monkeypatch, "SuBSENSEBGS")
    assert "bg_sum" in got[0] and "pend_ctrl" not in got[0]
    _check(want, got)
    st, masks = unsharded("SuBSENSEBGS", BATCH)
    assert torch.equal(masks, got[1])
    assert_tree_equal(st, got[0])
