"""XLA:CPU's f32 ``dot`` in its own order of additions: the one contraction
that the port's resize and Eigenbackground's PCA share.

``contract(A, B, plan)`` computes out[i, j] = Σ_k A[i, k] · B[k, j] with
every rounding where XLA:CPU makes it, as :class:`Plan` lays the sum out:

- the depth k is cut into blocks; each block is one FMA chain from +0 in
  index order, or (``lanes=4``) four FMA chains over its terms k ≡ l (mod
  4) counted from the block's start, added as ((l0 + l1) + (l2 + l3)), with
  the block's last ``len mod 4`` terms in a fifth chain added after;
- the blocks' sums are added to the output in order, or (``tree``) in the
  tree that Eigen's contraction sharded over its threads builds: ranges of
  4 blocks summed (b0 + b1) + (b2 + b3) (a short last range in order),
  then the ranges' sums added to the first, three at a time as (r0 + r1) +
  (r2 + r3), the rest in order;
- columns j >= ``split`` may take another block list (``alt``);
- ``lo``/``hi`` (int32 per row i) limit row i's sum to its band of nonzero
  terms of A (the resize's weights): a zero term leaves a chain unchanged.

XLA:CPU hands a ``dot`` to Eigen's tensor contraction on its intra-op
pool, whose inner products are MKL-DNN's sgemm (TensorFlow's custom
contraction kernel). Which order a shape gets was read off XLA's outputs
with three-leaf probes (terms 1, 0.75·2⁻²⁴ and −1 at three chosen k, zeros
elsewhere: the output tells which pair was added first) and each rule
below is held against ``jax.jit`` dots on random data in the tests:

- The inner-dimension sharding (:func:`eigen_shard_block`) is Eigen's own rule
  (``TensorContractionThreadPool.h``: ``numThreadsInnerDim``,
  ``shardByInnerDim``, ``blockSize``) with the test host's constants: a pool of
  :data:`POOL_THREADS` threads, Eigen built for AVX2 without FMA (packet
  :data:`PACKET` floats, ``Traits::nr`` 4, ``mr`` 24; the cost model's
  compute bandwidth 1.0 where FMA would give 0.5), an L3 of
  :data:`L3_BYTES`. It shards the resize's row contraction at 240-576 rows
  of 320-720 columns into blocks of 96 (12 packets) and leaves 720p and
  1080p alone.
- Unsharded, Eigen's blocking gives the row contraction ``ceil(k / 320)``
  equal slices rounded up to 8 (the multi-threaded ``kc`` cap of 320,
  then the custom kernel's equal slices); the column contraction and the
  Gram product take MKL-DNN's own depth blocks, 1,024 and 4,096 (measured).
- The Gram product ``Xc @ Xc.T`` ([S, D] by its transpose): blocks of
  4,096 in 4 lanes, added in order (measured at S = 5, 6, 8 and 18-24 with
  D a multiple of 4; other S or a D with a remainder mod 4 take other
  MKL-DNN kernels, not reproduced: ROADMAP).
- ``evecs.T @ Xc`` ([S, S] by [S, D]): at S = 20 one chain over k < 16 and
  one over 16-19, added, for the columns in whole panels of 2,048 (and in
  a last panel of 1,928 or more), one chain of 20 for the rest; at S = 8
  chains of 4 and 4 in panels of 8,192 (a last panel of 6,554 or more
  too). Other S take one chain (not verified: ROADMAP).

On CUDA tensors ``contract`` launches the kernel pair ``contract`` of
``csrc/contract.cu`` (the chains, then their sums in the plan's order);
CPU tensors take the plain version :func:`contract_ref`.

The test host (the CPU the tests run the JAX package on), read by
``lscpu`` and sysfs's cache entries: an Intel Xeon (Sapphire Rapids,
AVX-512) with 8 cores, 48 KiB L1d and 2 MiB L2 a core, 105 MiB of L3. XLA's pool has one thread a core
(``PJRT_NPROC`` and ``taskset`` change nothing: the pool is sized from the
core count); the packet of 8 floats shows in the smallest shard, 96 = 12
packets. To re-derive them on another host, probe the shapes of
``tests/test_torch_contract.py`` with three-leaf inputs and compare the
block boundaries and trees with these rules.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch

from tracking_tpu_torch.ops import _native, xla_math

_F32 = torch.float32

POOL_THREADS = 8  # XLA:CPU's intra-op pool on the test host: one thread a core
PACKET = 8  # Eigen's float packet (AVX2 build): the smallest shard is 12 packets
NR, MR = 4, 24  # Eigen's gebp_traits<float, float> register block for that packet
L3_BYTES = 105 * 1024 * 1024
_LOAD = _STORE = 11.0 / 64  # TensorCostModel's cycles per loaded / stored byte
_BANDWIDTH = 1.0  # computeBandwidth without EIGEN_VECTORIZE_FMA (0.5 with it)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How XLA:CPU orders one dot's sum over k (see the module note).
    ``blocks`` are [k0, k1) ranges in order; ``alt`` the blocks of the
    columns j >= ``split``."""

    blocks: tuple
    lanes: int = 1
    tree: bool = False
    split: int | None = None
    alt: tuple | None = None


def _cost_per_k(m: int, n: int) -> float:
    """Eigen's contractionCostPerInnerDim(m, n, k) / k in cycles."""
    bw = 2.0 if (n < NR or m < MR) else _BANDWIDTH
    return bw * m * n / PACKET + _STORE * 4 + _LOAD * 4 * n


def _threads_inner(m: int, n: int, k: int) -> int:
    """Eigen's numThreadsInnerDim: the even thread count of least modelled cost."""
    parallel = k * _cost_per_k(m, n)
    reduction = m * n * (_LOAD * 2 + _STORE * 1 + 1.0 / PACKET)
    best, cost = 1, parallel
    for nt in range(2, POOL_THREADS + 1, 2):
        c = parallel / nt + 100000 + nt * (reduction + 3000)
        if c < cost:
            best, cost = nt, c
    return best


def _shard_by_col(m: int, n: int, t: int) -> bool:
    """Eigen's shardByCol."""
    if m // t >= NR and (n // t < NR or (n // t < 4 * NR and n % (t * NR) != 0
                                         and (m % (t * NR) == 0 or m // n >= 6))):
        return False
    return not (n // t < 16 * NR and m > n * 32)


def _threads(m: int, n: int, k: int) -> int:
    """Eigen's TensorCostModel::numThreads for the output m x n (the first
    sharding guess at 2 threads, bk capped at 320; the fitted model counts
    the whole m and n as the register blocks)."""
    bk = min(k, 320)
    col = _shard_by_col(m, n, 2)
    bw = 2.0 if ((n if col else m) < NR or (m if col else n) < MR) else _BANDWIDTH
    per = bk * bw / PACKET + _STORE * 4 + _LOAD * 4 * bk / (m if col else n)
    th = (m * n * per - 100000) / 100000 + 0.9
    return min(POOL_THREADS, max(1, int(th)))


def eigen_shard_block(m: int, n: int, k: int) -> int:
    """Eigen's shardByInnerDim and blockSize for Eigen's m x n output (XLA's
    row-major [n, m]) over k: the depth of a shard (0 where it does not
    shard)."""
    t, tk = _threads(m, n, k), _threads_inner(m, n, k)
    if n == 1 or tk < 2 or tk < t or m * n * 4 > L3_BYTES / tk or k / tk < 2 * NR:
        return 0
    if max(m, n) / t < NR or (k / tk > 8 * NR and (min(m, n) < 2 * NR or tk > t)):
        return min(k, max(12 * PACKET, -(-(-(-k // tk)) // 8) * 8))
    return 0


def _even_blocks(k: int, size: int) -> tuple:
    return tuple((s, min(k, s + size)) for s in range(0, k, size))


@lru_cache(maxsize=None)
def resize_rows_plan(k: int, q: int, p: int) -> Plan:
    """The resize's contraction over its rows: out [p, q] (row-major) over k
    input rows. Sharded by Eigen's rule, else equal slices of <= 320."""
    size = eigen_shard_block(q, p, k)
    if size:
        return Plan(_even_blocks(k, size), tree=True)
    slices = -(-k // 320)
    return Plan(_even_blocks(k, min(k, -(-(k // slices) // 8) * 8)))


@lru_cache(maxsize=None)
def resize_cols_plan(k: int) -> Plan:
    """The resize's contraction over its columns: MKL-DNN's blocks of 1,024."""
    return Plan(_even_blocks(k, 1024))


@lru_cache(maxsize=None)
def gram_plan(s: int, d: int) -> Plan:
    """``Xc @ Xc.T`` for Xc [S, D]: blocks of 4,096 in 4 lanes, in order."""
    return Plan(_even_blocks(d, 4096), lanes=4)


# S -> (where the depth splits, panel width, the narrowest last panel that still splits)
_LIFT_SPLIT = {20: (16, 2048, 1928), 8: (4, 8192, 6554)}


@lru_cache(maxsize=None)
def lift_plan(s: int, d: int) -> Plan:
    """``evecs.T @ Xc`` ([S, S] by [S, D]): for S in ``_LIFT_SPLIT``, columns
    in whole panels (and a last panel at least the threshold wide) sum k <
    split and k >= split in two chains, added; the others one chain."""
    if s not in _LIFT_SPLIT:
        return Plan(((0, s),))
    at, width, least = _LIFT_SPLIT[s]
    cols = width * (d // width)
    if d - cols >= least:
        cols = d
    return Plan(((0, at), (at, s)), split=cols, alt=((0, s),))


def _chains(blocks, lanes: int):
    """(k0, step, count) of every FMA chain of ``blocks`` and each block's
    first chain index and chain count."""
    chains, first, count = [], [], []
    for k0, k1 in blocks:
        first.append(len(chains))
        n = k1 - k0
        if lanes == 1:
            chains.append((k0, 1, n))
        else:
            main = n // lanes * lanes
            chains += [(k0 + l, lanes, main // lanes) for l in range(lanes)]
            if n > main:
                chains.append((k0 + main, 1, n - main))
        count.append(len(chains) - first[-1])
    return chains, first, count


def _combine(parts, first, count, lanes: int, tree: bool):
    """The output from the chains' sums [C, ...] in the plan's order."""
    sums = []
    for f, c in zip(first, count):
        if lanes == 1:
            s = parts[f]
        else:
            s = (parts[f] + parts[f + 1]) + (parts[f + 2] + parts[f + 3])
            if c > lanes:
                s = s + parts[f + lanes]
        sums.append(s)
    if not tree:
        out = torch.zeros_like(sums[0])
        for s in sums:
            out = out + s
        return out
    ranges = []
    for r in range(0, len(sums), 4):
        grp = sums[r : r + 4]
        if len(grp) == 4:
            ranges.append((grp[0] + grp[1]) + (grp[2] + grp[3]))
        else:
            acc = grp[0]
            for g in grp[1:]:
                acc = acc + g
            ranges.append(acc)
    out, i = ranges[0], 1
    while i + 2 < len(ranges):
        out = (out + ranges[i]) + (ranges[i + 1] + ranges[i + 2])
        i += 3
    for r in ranges[i:]:
        out = out + r
    return out


def _chain_sums(A, B, chains, lo, hi):
    """[C, P, Q]: each chain's FMA sum from +0 (vectorised over chains and
    outputs, looped over a chain's depth); row i adds only k in [lo_i, hi_i]."""
    dev = A.device
    k0 = torch.tensor([c[0] for c in chains], device=dev)
    step = torch.tensor([c[1] for c in chains], device=dev)
    cnt = torch.tensor([c[2] for c in chains], device=dev)
    P, Q, K = A.shape[0], B.shape[1], A.shape[1]
    acc = torch.zeros((len(chains), P, Q), dtype=_F32, device=dev)
    for s in range(int(cnt.max()) if chains else 0):
        k = k0 + s * step
        live = (s < cnt)[:, None]  # [C, 1]
        kc = k.clamp(max=K - 1)
        if lo is not None:
            live = live & (kc[:, None] >= lo[None]) & (kc[:, None] <= hi[None])  # [C, P]
        a = A[:, kc].T  # [C, P]
        b = B[kc]  # [C, Q]
        acc = torch.where(live[..., None], xla_math.fma(a[..., None], b[:, None, :], acc), acc)
    return acc


def contract_ref(A: torch.Tensor, B: torch.Tensor, plan: Plan, lo=None, hi=None) -> torch.Tensor:
    """Plain version: A f32 [P, K], B f32 [K, Q] -> f32 [P, Q] in ``plan``'s order."""
    groups = [(plan.blocks, slice(None))]
    if plan.alt is not None:
        groups = [(plan.blocks, slice(0, plan.split)), (plan.alt, slice(plan.split, None))]
    out = torch.empty((A.shape[0], B.shape[1]), dtype=_F32, device=A.device)
    for blocks, cols in groups:
        chains, first, count = _chains(blocks, plan.lanes)
        parts = _chain_sums(A, B[:, cols], chains, lo, hi)
        out[:, cols] = _combine(parts, first, count, plan.lanes, plan.tree)
    return out


@lru_cache(maxsize=None)
def _plan_tables(plan: Plan, device: str):
    """int32 tables of ``plan`` for the kernel: chains (k0, step, count,
    group) and blocks (first chain, chain count, group)."""
    rows_c, rows_b = [], []
    for g, blocks in enumerate([plan.blocks] + ([plan.alt] if plan.alt is not None else [])):
        chains, first, count = _chains(blocks, plan.lanes)
        base = len(rows_c)
        rows_c += [(k0, st, n, g) for k0, st, n in chains]
        rows_b += [(base + f, c, g) for f, c in zip(first, count)]
    tc = torch.tensor(rows_c, dtype=torch.int32).T.contiguous().to(device)
    tb = torch.tensor(rows_b, dtype=torch.int32).T.contiguous().to(device)
    return tc, tb


def contract(A: torch.Tensor, B: torch.Tensor, plan: Plan, lo=None, hi=None, out_t: bool = False,
             use_kernels: bool = True) -> torch.Tensor:
    """out = A @ B in ``plan``'s order; A f32 [P, K] and B f32 [K, Q] (any
    strides); ``out_t`` returns out.T ([Q, P], contiguous). CUDA tensors
    launch the kernel pair ``contract`` (unless ``use_kernels=False``); CPU
    tensors take :func:`contract_ref`; another device raises."""
    if A.device.type == "cpu" or not use_kernels:
        out = contract_ref(A, B, plan, lo, hi)
        return out.T.contiguous() if out_t else out
    _native.require(A, "lhs", _F32, contiguous=False)  # the kernel takes A's and B's strides
    _native.require(B, "rhs", _F32, contiguous=False)
    P, K = A.shape
    Q = B.shape[1]
    tc, tb = _plan_tables(plan, str(A.device))
    C, NB = tc.shape[1], tb.shape[1]
    parts = torch.empty((C, P, Q), dtype=_F32, device=A.device)
    out = torch.empty((Q, P) if out_t else (P, Q), dtype=_F32, device=A.device)
    so = (1, P) if out_t else (Q, 1)
    null = 0
    rc = _native.library().tt_contract(
        A.data_ptr(), B.data_ptr(), lo.data_ptr() if lo is not None else null,
        hi.data_ptr() if hi is not None else null, tc.data_ptr(), tb.data_ptr(), parts.data_ptr(), out.data_ptr(),
        P, Q, C, NB, A.stride(0), A.stride(1), B.stride(0), B.stride(1), so[0], so[1],
        plan.lanes, int(plan.tree), plan.split if plan.alt is not None else Q, _native.stream_ptr())
    _native.check(rc, "contract")
    _native.count_launch("contract")
    return out
