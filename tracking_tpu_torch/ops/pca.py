"""Eigenbackground's PCA arithmetic in XLA:CPU's orders: the per-frame
projection and reconstruction (:func:`project`) and the norms of the
lifted components (:func:`row_norms`).

XLA:CPU runs the step's two dots, ``basis @ xc`` ([E, D] by [D]) and
``basis.T @ proj`` ([D, E] by [E], the transpose copied row-major first),
through its row-major matrix-vector emitter (``row_major_gemv`` in the
dumped LLVM IR: tiles of 8 rows by 8 columns). A row keeps 8 f32 lanes,
lane l an FMA chain from +0 over the columns c = l (mod 8) below C8 = C −
C mod 8, and the columns from C8 on in one more chain; the lanes are added
((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)) for a row in a whole tile of 8
rows, ((0 + 4) + (2 + 6)) + ((1 + 5) + (3 + 7)) for a row of the last
partial tile, and the tail chain after. The reconstruction adds the mean
to the dot (``mean + basis.T @ proj``).

``jnp.linalg.norm(comps, axis=1)`` squares and reduces along D in windows
of 32 per level (XLA:CPU's reduce-window), each window summed in index
order from +0, zero-padded on both sides to whole windows (the lower side
the smaller half), then ``sqrt`` (``xla_math.sqrt``).

On CUDA tensors :func:`project` launches ``csrc/pca.cu`` (``pca_project``:
the projection in one block, the reconstruction a thread a value); CPU
tensors take :func:`project_ref`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tracking_tpu_torch.ops import _native, xla_math

_F32 = torch.float32
_WINDOW = 32


def _lane_tree(lanes: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """lanes [..., 8] f32 -> [...]: the whole tile's tree where ``whole``,
    else the partial tile's."""
    l = lanes.unbind(-1)
    a = ((l[0] + l[1]) + (l[2] + l[3])) + ((l[4] + l[5]) + (l[6] + l[7]))
    b = ((l[0] + l[4]) + (l[2] + l[6])) + ((l[1] + l[5]) + (l[3] + l[7]))
    return torch.where(whole, a, b)


def _rows_gemv(M: torch.Tensor, v: torch.Tensor, rows_axis_last: bool = False) -> torch.Tensor:
    """XLA's row-major matrix-vector product M [R, C] · v [C] -> [R] (``M``
    given as [C, R] when ``rows_axis_last``), looped over the columns."""
    R = M.shape[1] if rows_axis_last else M.shape[0]
    C = v.shape[0]
    C8 = C - C % 8
    col = (lambda c: M[c]) if rows_axis_last else (lambda c: M[:, c])
    lanes = torch.zeros((R, 8), dtype=_F32, device=M.device)
    for c in range(0, C8, 8):
        blk = M[c : c + 8].T if rows_axis_last else M[:, c : c + 8]
        lanes = xla_math.fma(blk, v[c : c + 8][None], lanes)
    tail = torch.zeros(R, dtype=_F32, device=M.device)
    for c in range(C8, C):
        tail = xla_math.fma(col(c), v[c], tail)
    whole = torch.arange(R, device=M.device) < R - R % 8
    return _lane_tree(lanes, whole) + tail


def project_ref(basis: torch.Tensor, xc: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Plain version: mean + basis.T @ (basis @ xc) in XLA:CPU's orders."""
    if not bool(basis.any()):  # a zero basis (the history still filling): every chain is +0
        return mean + 0.0
    proj = _rows_gemv(basis, xc)
    return mean + _rows_gemv(basis, proj, rows_axis_last=True)


def project(basis: torch.Tensor, xc: torch.Tensor, mean: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
    """f32 basis [E, D], xc [D], mean [D] -> recon [D]. CUDA tensors launch
    ``pca_project`` (unless ``use_kernels=False``); CPU tensors take
    :func:`project_ref`; another device raises."""
    if basis.device.type == "cpu" or not use_kernels:
        return project_ref(basis, xc, mean)
    E, D = basis.shape
    for t, name, shape in ((basis, "basis", (E, D)), (xc, "xc", (D,)), (mean, "mean", (D,))):
        _native.require(t, name, _F32, shape)
    proj = torch.empty(E, dtype=_F32, device=basis.device)
    recon = torch.empty(D, dtype=_F32, device=basis.device)
    rc = _native.library().tt_pca_project(basis.data_ptr(), xc.data_ptr(), mean.data_ptr(), proj.data_ptr(),
                                          recon.data_ptr(), E, D, _native.stream_ptr())
    _native.check(rc, "pca_project")
    _native.count_launch("pca_project")
    return recon


def window_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis of f32 [..., D] in XLA:CPU's reduce-window order."""
    D = x.shape[-1]
    if D > _WINDOW:
        pad = -(-D // _WINDOW) * _WINDOW - D
        x = F.pad(x, (pad // 2, pad - pad // 2)).reshape(*x.shape[:-1], -1, _WINDOW)
    s = torch.zeros(x.shape[:-1], dtype=_F32, device=x.device)
    for k in range(x.shape[-1]):
        s = s + x[..., k]
    return window_sum(s) if D > _WINDOW else s


def row_norms(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(x, axis=1)`` of f32 [R, D] as XLA:CPU computes it."""
    return xla_math.sqrt(window_sum(x * x))
