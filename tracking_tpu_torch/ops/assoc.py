"""Greedy min-cost track↔blob assignment: the CUDA kernel ``greedy_assign``
(``csrc/assoc.cu``, replacing ``tracking_tpu/ops/pallas_assoc.py:
greedy_assign_pallas``) and its plain version, the ``while_loop`` of
``tracking_tpu/track/tracker.py:195-217``.

Repeatedly take the global argmin of a gated [K, B] cost matrix (ties go to
the lowest flat index), assign that (track, blob) pair and mask its row and
column, until the minimum is gated (>= 1e9) or min(K, B) pairs are made.
"""

from __future__ import annotations

import torch

from tracking_tpu_torch.ops import _native

BIG = 1e9
MAX_CELLS = 4096  # one thread block holds the whole matrix in shared memory


def greedy_assign_ref(cost: torch.Tensor):
    """Plain torch. Returns (assign [K] int32 blob index or -1, taken [B] bool)."""
    K, B = cost.shape
    big = torch.full((), BIG, dtype=torch.float32, device=cost.device)
    assign = torch.full((K,), -1, dtype=torch.int32, device=cost.device)
    taken = torch.zeros(B, dtype=torch.bool, device=cost.device)
    cost = cost.clone()
    for _ in range(min(K, B)):
        flat = int(torch.argmin(cost))
        k, b = flat // B, flat % B
        if not bool(cost[k, b] < big):
            break
        assign[k] = b
        taken[b] = True
        cost[k, :] = big
        cost[:, b] = big
    return assign, taken


def greedy_assign(cost: torch.Tensor):
    """Pre-gated [K, B] f32 cost -> (assign [K] int32, taken [B] bool). CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if cost.device.type == "cpu":
        return greedy_assign_ref(cost)
    K, B = cost.shape
    _native.require(cost, "cost", torch.float32, (K, B))
    if K * B > MAX_CELLS:
        raise ValueError(f"greedy_assign takes at most {MAX_CELLS} cells, got {K}x{B}")
    assign = torch.empty(K, dtype=torch.int32, device=cost.device)
    taken = torch.empty(B, dtype=torch.bool, device=cost.device)
    rc = _native.library().tt_greedy_assign(
        cost.data_ptr(), assign.data_ptr(), taken.data_ptr(), K, B, _native.stream_ptr()
    )
    _native.check(rc, "greedy_assign")
    _native.count_launch("greedy_assign")
    return assign, taken
