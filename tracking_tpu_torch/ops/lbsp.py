"""LBSP (Local Binary Similarity Pattern) descriptor, counterpart of
``tracking_tpu/ops/lbsp.py``.

The 16-bit double-cross pattern: bit i = (|neighbor_i − ref| > thr), with
the neighbors in the bit order of :data:`OFFSETS`. Border pixels read
clamped (edge-replicated) neighbors, as the reference's edge padding does.
The descriptor helpers (:func:`descriptor_bits`, :func:`pack_bits`,
:func:`unpack_bits`, :func:`compute_descriptor`, :func:`hamming16`) are
the JAX module's public ones; the consensus step computes the same bits in
its own code.
"""

from __future__ import annotations

import torch

# (x=col, y=row) offsets in bit order 0..15
OFFSETS = (
    (-2, 0), (2, 0), (0, -2), (0, 2),
    (-2, 2), (2, -2), (2, 2), (-2, -2),
    (0, 1), (-1, 0), (0, -1), (1, 0),
    (-1, -1), (1, 1), (1, -1), (-1, 1),
)

BITS = 16
BORDER = 2


def edge_pad(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Edge-replicate padding of the last two dims (any dtype)."""
    H, W = x.shape[-2], x.shape[-1]
    rows = torch.arange(-top, H + bottom, device=x.device).clamp(0, H - 1)
    cols = torch.arange(-left, W + right, device=x.device).clamp(0, W - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def neighbor_stack(img: torch.Tensor) -> torch.Tensor:
    """u8 [H, W] -> int16 [16, H, W]: neighbor planes in bit order."""
    H, W = img.shape[-2], img.shape[-1]
    x = edge_pad(img, BORDER, BORDER, BORDER, BORDER).to(torch.int16)
    planes = [
        x[..., BORDER + dy : BORDER + dy + H, BORDER + dx : BORDER + dx + W]
        for dx, dy in OFFSETS
    ]
    return torch.stack(planes, dim=0)


def popcount16(x: torch.Tensor) -> torch.Tensor:
    """Population count of 16-bit values (SWAR in int32)."""
    v = x.to(torch.int32) & 0xFFFF
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def descriptor_bits(nb: torch.Tensor, ref: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """bool [16, H, W]: |neighbor − ref| > thr per bit, in int16 (``ref`` and
    ``thr`` [H, W] broadcast over the bit axis)."""
    return (nb - ref.to(torch.int16)[None]).abs() > thr.to(torch.int16)[None]


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool [16, ...] -> uint16 [...] descriptor (bit i from plane i)."""
    shifts = torch.arange(BITS, dtype=torch.int32, device=bits.device).reshape((BITS,) + (1,) * (bits.ndim - 1))
    return (bits.to(torch.int32) << shifts).sum(0, dtype=torch.int32).to(torch.uint16)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """uint16 [...] -> bool [16, ...]."""
    shifts = torch.arange(BITS, dtype=torch.int32, device=desc.device).reshape((BITS,) + (1,) * desc.ndim)
    return ((desc.to(torch.int32)[None] >> shifts) & 1).to(torch.bool)


def compute_descriptor(img: torch.Tensor, ref: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """Full LBSP: u8 image [H, W], reference map, threshold map -> u16 [H, W]."""
    return pack_bits(descriptor_bits(neighbor_stack(img), ref, thr))


def hamming16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance (int32) between u16 descriptor maps (``hdist``,
    ``pl/DistanceUtils.h:286-288``)."""
    return popcount16(a.to(torch.int32) ^ b.to(torch.int32))
