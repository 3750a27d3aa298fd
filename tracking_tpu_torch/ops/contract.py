"""XLA:CPU's f32 ``dot`` in its own order of additions: the one contraction
that the port's resize and Eigenbackground's PCA share.

``contract(A, B, plan)`` computes out[i, j] = Σ_k A[i, k] · B[k, j] with
every rounding where XLA:CPU makes it, as :class:`Plan` lays the sum out:

- the depth k is cut into blocks; each block is one FMA chain from +0 in
  index order, or (``lanes`` 2 or 4) that many FMA chains over its terms k
  ≡ l (mod lanes) counted from the block's start, added as l0 + l1 or ((l0
  + l1) + (l2 + l3)), with the block's last ``len mod lanes`` terms in one
  more chain of rounded products (no FMA) added after;
- the blocks' sums are added to the output in order, or (``tree``) in the
  tree that Eigen's contraction sharded over its threads builds: ranges of
  4 blocks summed (b0 + b1) + (b2 + b3) (a short last range in order),
  then the ranges' sums added to the first, three at a time as (r0 + r1) +
  (r2 + r3), the rest in order;
- columns j >= ``split`` may take another block list (``alt``), whose
  chains add rounded products where ``alt_fma`` is off;
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
- The Gram product ``Xc @ Xc.T`` ([S, D] by its transpose), by MKL-DNN's
  kernel for S rows (:func:`gram_lanes`, :func:`gram_block`): one FMA
  chain over all of D at S <= 3, at D < 4, and at S < 8 for D < 8;
  otherwise 4 lanes, or 2 at 25-32 rows (and at 17-24 rows where D mod 4
  is 1 or 2 and D <= 90), 4 at 33-48 rows (one chain at D = 5, 6, 9), one
  chain at 49-64, over the depth to the last multiple of the lanes in
  blocks of 8,192 / ceil(S / 4) rounded down to 8 (S <= 16), 4,096
  (17-24), 1,024 (2 lanes), 2,048 (33-48) or 512 (49-64), the rest of D
  (< lanes terms) as rounded products after the last block. Read off
  probes at S = 2-64 and D = 1-20,000 (the lanes and the tail's joins on
  depths 1-100, the block starts by scanning lane 0), held on random data
  at every S for D = 1-40, 86-96, the frames' sizes and the blocks' edges
  up to 230,400 (33-64 rows: D = 1-47, 89-94, 512-9,000).
- The lift ``evecs.T @ Xc`` ([S, S] by [S, D]), by :func:`lift_plan`: the
  columns in panels of 16,384 (S < 8), 8,192 (8-15), 4,096 (16), 2,048
  (17-32) or 1,024 (33-50); a panel w columns wide sums the depth in chains
  of floor(32,768 / w) terms (MKL-DNN's A panel of 128 KiB: 16 at 2,048),
  each from +0, the chains' sums added in order; a last panel of <= 8
  columns adds rounded products at S in :data:`_NARROW_ADDS`; S <= 3 one
  chain; frames of 2-16 values take the Gram kernel's 4 lanes over the
  depth at the (S, D) of :func:`_small_lift_lanes`. At 51-64 rows
  (:func:`_wide_lift_plan`) the whole output takes one order by r = (D -
  1) mod 64 + 1, as the Gram kernel would with rows and depth swapped: 4
  lanes over S (r in 1-16, 33-48), 2 (25-32; 17-24 where D > 64 or S mod 4
  is 1 or 2), one chain (49-64). Held at D = 2-100, 128, 256, 768, 851 and
  900-5,000 (9 depths) for S = 52, 60, 64, and for S = 51, 53, 57, 63 to
  851, at 1,300, 1,500, 2,304, 2,553, 3,000 and at the frames of 6,912
  (48x48x3) to 691,200 (360x640x3) values; there some depths of 900-5,000
  take one chain instead (1,000, 1,200, 4,000, 5,000; at 53 and 57 also
  900, 1,100, 1,800, 2,000: Eigen's threads over the columns, not
  reproduced, ROADMAP). A 1x1 grey frame (D = 1) is a matrix-vector
  product (XLA's own emitter), not reproduced. Read off the probes'
  per-column split points (triplets (t - 1, t, t + 1) at every column at
  once) at S = 3-64 and D = 100-40,000, and at 51-64 rows by which of the
  candidate orders each column's outputs equal on random data.

On CUDA tensors ``contract`` (the resize's contractions, with their bands
and Eigen's tree) launches the kernel pair ``contract_chains_kernel`` and
``contract_combine_kernel`` of ``csrc/contract.cu`` (the chains, then their
sums in the plan's order); :func:`gram` (``Xc @ Xc.T`` from Xc itself)
launches ``gram_block_kernel`` (a CTA a depth block, the slab in
shared-memory stages, register tiles of the upper triangle) and
``gram_combine_kernel`` (the blocks' sums in order, both triangles);
:func:`lift` (``evecs.T @ Xc``) one ``lift_kernel``. All count under
``contract``; CPU tensors take the plain version :func:`contract_ref`.

The test host (the CPU the tests run the JAX package on), read by
``lscpu`` and sysfs's cache entries: an Intel Xeon (Sapphire Rapids,
AVX-512) with 8 cores, 48 KiB L1d and 2 MiB L2 a core, 105 MiB of L3. XLA's pool has one thread a core
(``PJRT_NPROC`` and ``taskset`` change nothing: the pool is sized from the
core count); the packet of 8 floats shows in the smallest shard, 96 = 12
packets. To re-derive them on another host: ``tools/probe_orders.py``
rebuilds a dot's tree from three-leaf probes, reads each join's rounding
(an FMA or a rounded product) from two-leaf probes, scans the Gram
kernel's block starts and the lift's per-column splits; then
``tests/test_torch_contract.py`` holds the rules on random data.
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
    alt_fma: bool = True  # False: the ``alt`` columns add rounded products


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


def gram_lanes(s: int, d: int) -> int:
    """The FMA lanes of MKL-DNN's kernel for ``Xc @ Xc.T`` at S rows and depth D."""
    if s <= 3 or d < 4 or (s < 8 and d < 8) or s >= 49:
        return 1
    if s >= 33:
        return 1 if d in (5, 6, 9) else 4
    if s >= 25 or (s >= 17 and d % 4 in (1, 2) and d <= 90):
        return 2
    return 4


def gram_block(s: int) -> int:
    """The depth of one of the Gram kernel's blocks: 8,192 over the 4-row
    groups of S (rounded down to 8) up to 16 rows, 4,096 for 17-24 rows,
    1,024 in the 2-lane kernel (25-32), 2,048 for 33-48 rows and 512 in the
    one-chain kernel of 49-64 rows."""
    if s >= 49:
        return 512
    if s >= 33:
        return 2048
    if s >= 25:
        return 1024
    if s >= 17:
        return 4096
    return 8192 // -(-s // 4) // 8 * 8


@lru_cache(maxsize=None)
def gram_plan(s: int, d: int) -> Plan:
    """``Xc @ Xc.T`` for Xc [S, D]: one FMA chain, or blocks of
    :func:`gram_block` in :func:`gram_lanes` lanes over the depth to the
    last multiple of the lanes, then the rest as rounded products, added in
    order."""
    lanes = gram_lanes(s, d)
    if lanes == 1:
        return Plan(_even_blocks(d, gram_block(s)) if s >= 49 else ((0, d),))
    main = d - d % lanes
    tail = ((main, d),) if d > main else ()
    return Plan(_even_blocks(main, gram_block(s)) + tail, lanes=lanes)


def _small_lift_lanes(s: int, d: int) -> int:
    """Frames of at most 16 values take the Gram's kernel: 4 lanes over the
    depth, or one chain (read off probes for S = 4-32, D = 2-16)."""
    if s < 8:
        return 4 if d >= 8 and (d == 8 and s != 5 or s in (4, 7)) else 1
    return 4 if d <= 8 or s not in (9, 10, 13, 17) else 1


_NARROW_ADDS = frozenset((4, 6, 11, 12, 17, 18, 41, 42))  # S whose last panel of <= 8 columns adds rounded products


def lift_panel(s: int) -> int:
    """The column panel of MKL-DNN's kernel for ``evecs.T @ Xc`` at S rows."""
    if s >= 33:
        return 1024
    if s >= 17:
        return 2048
    if s >= 16:
        return 4096
    return 8192 if s >= 8 else 16384



def _wide_lift_plan(s: int, d: int) -> Plan:
    """The lift at 51-64 rows: the Gram kernel with the roles of rows and
    depth swapped, chosen by r = (D - 1) mod 64 + 1: 4 lanes over S (r <=
    16 and 33-48), 2 lanes (25-32, and 17-24 where D > 64 or S mod 4 is 1
    or 2), one chain (49-64); a lane plan's last S mod lanes terms are
    rounded products added after."""
    r = (d - 1) % 64 + 1
    if r > 48:
        return Plan(((0, s),))
    lanes = 2 if 25 <= r <= 32 or (17 <= r <= 24 and (d > 64 or s % 4 in (1, 2))) else 4
    main = s - s % lanes
    return Plan(((0, main),) + (((main, s),) if s > main else ()), lanes=lanes)


@lru_cache(maxsize=None)
def lift_plan(s: int, d: int) -> Plan:
    """``evecs.T @ Xc`` ([S, S] by [S, D]): the columns in panels of
    :func:`lift_panel` (the last one narrower); a panel w columns wide sums
    its depth in chains of floor(32,768 / w) terms (A's panel of 128 KiB),
    each from +0, added in order; one chain where that covers S."""
    if s <= 3:
        return Plan(((0, s),))
    if s >= 51:
        return _wide_lift_plan(s, d)
    if d <= 16 and _small_lift_lanes(s, d) == 4:
        return Plan(((0, s),), lanes=4)
    width = lift_panel(s)
    whole = d // width * width

    def chains(w):
        return _even_blocks(s, max(1, min(s, 32768 // w)))

    if whole == 0:
        return Plan(chains(d))
    if whole == d:
        return Plan(chains(width))
    narrow = d - whole <= 8 and s in _NARROW_ADDS  # one chain of rounded products
    return Plan(chains(width), split=whole, alt=chains(d - whole), alt_fma=not narrow)


def _chains(blocks, lanes: int, fma: bool = True):
    """(k0, step, count, fused) of every FMA chain of ``blocks`` and each
    block's first chain index and chain count. A lane plan's tail chain adds
    rounded products (fused 0), as does every chain where ``fma`` is off."""
    chains, first, count = [], [], []
    for k0, k1 in blocks:
        first.append(len(chains))
        n = k1 - k0
        if lanes == 1:
            chains.append((k0, 1, n, int(fma)))
        else:
            main = n // lanes * lanes
            chains += [(k0 + l, lanes, main // lanes, int(fma)) for l in range(lanes)]
            if n > main:
                chains.append((k0 + main, 1, n - main, 0))
        count.append(len(chains) - first[-1])
    return chains, first, count


def _combine(parts, first, count, lanes: int, tree: bool):
    """The output from the chains' sums [C, ...] in the plan's order."""
    sums = []
    for f, c in zip(first, count):
        if lanes == 1:
            s = parts[f]
        elif lanes == 2:
            s = parts[f] + parts[f + 1]
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
    fused = torch.tensor([bool(c[3]) for c in chains], device=dev)
    all_fused, any_fused = all(c[3] for c in chains), any(c[3] for c in chains)
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
        if all_fused:
            nxt = xla_math.fma(a[..., None], b[:, None, :], acc)
        elif not any_fused:
            nxt = acc + a[..., None] * b[:, None, :]
        else:
            nxt = torch.where(fused[:, None, None], xla_math.fma(a[..., None], b[:, None, :], acc),
                              acc + a[..., None] * b[:, None, :])
        acc = torch.where(live[..., None], nxt, acc)
    return acc


def contract_ref(A: torch.Tensor, B: torch.Tensor, plan: Plan, lo=None, hi=None) -> torch.Tensor:
    """Plain version: A f32 [P, K], B f32 [K, Q] -> f32 [P, Q] in ``plan``'s order."""
    groups = [(plan.blocks, slice(None), True)]
    if plan.alt is not None:
        groups = [(plan.blocks, slice(0, plan.split), True), (plan.alt, slice(plan.split, None), plan.alt_fma)]
    out = torch.empty((A.shape[0], B.shape[1]), dtype=_F32, device=A.device)
    for blocks, cols, fma in groups:
        chains, first, count = _chains(blocks, plan.lanes, fma)
        parts = _chain_sums(A, B[:, cols], chains, lo, hi)
        out[:, cols] = _combine(parts, first, count, plan.lanes, plan.tree)
    return out


@lru_cache(maxsize=None)
def _plan_tables(plan: Plan, device: str):
    """int32 tables of ``plan`` for the kernel: chains (k0, step, count,
    group, fused) and blocks (first chain, chain count, group)."""
    rows_c, rows_b = [], []
    groups = [(plan.blocks, True)] + ([(plan.alt, plan.alt_fma)] if plan.alt is not None else [])
    for g, (blocks, fma) in enumerate(groups):
        chains, first, count = _chains(blocks, plan.lanes, fma)
        base = len(rows_c)
        rows_c += [(k0, st, n, g, f) for k0, st, n, f in chains]
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


@lru_cache(maxsize=None)
def _gram_table(plan: Plan, device: str) -> torch.Tensor:
    """int32 [2, NB] of a Gram plan for ``gram_block_kernel``: each depth
    block's k0 and k1, a CTA each (blockIdx.x = the block's place in the
    order its sums are added)."""
    if plan.tree or plan.alt is not None:
        raise ValueError("gram takes a plan with its blocks added in order and one column group")
    return torch.tensor(plan.blocks, dtype=torch.int32).T.contiguous().to(device)


@lru_cache(maxsize=None)
def _lift_table(plan: Plan, device: str) -> torch.Tensor:
    """int32 table of a lift plan for ``lift_kernel``: the block counts of
    column groups 0 and 1, their FMA flags (group 1's rounded products where
    ``alt_fma`` is off), then each group's blocks as k0, k1 in order."""
    if plan.tree:
        raise ValueError("lift takes a plan with its blocks added in order")
    alt = plan.alt or ()
    rows = [len(plan.blocks), len(alt), 1, int(plan.alt_fma)]
    rows += [k for blk in plan.blocks + alt for k in blk]
    return torch.tensor(rows, dtype=torch.int32).to(device)


def _rows(X: torch.Tensor, name: str) -> None:
    _native.require(X, name, _F32, contiguous=False)  # the kernels take the row stride
    if X.dim() != 2 or X.stride(1) != 1:
        raise ValueError(f"{name}: expected a 2-D tensor with unit column stride")


def gram(X: torch.Tensor, plan: Plan, use_kernels: bool = True) -> torch.Tensor:
    """``X @ X.T`` in ``plan``'s order (a :func:`gram_plan`) for X f32 [S, D]
    with unit column stride -> f32 [S, S], exactly symmetric. CUDA tensors
    launch ``gram_block_kernel`` and ``gram_combine_kernel`` (unless
    ``use_kernels=False``); CPU tensors take :func:`contract_ref`."""
    if X.device.type == "cpu" or not use_kernels:
        return contract_ref(X, X.T, plan)
    _rows(X, "X")
    S, D = X.shape
    tab = _gram_table(plan, str(X.device))
    NB = tab.shape[1]
    if plan.blocks[-1][1] != D:
        raise ValueError(f"gram: the plan covers a depth of {plan.blocks[-1][1]}, X has {D}")
    partial = torch.empty((NB, S * (S + 1) // 2), dtype=_F32, device=X.device)
    out = torch.empty((S, S), dtype=_F32, device=X.device)
    rc = _native.library().tt_contract_gram(X.data_ptr(), tab.data_ptr(), partial.data_ptr(), out.data_ptr(), S,
                                            X.stride(0), NB, plan.lanes, _native.stream_ptr())
    _native.check(rc, "contract")
    _native.count_launch("contract")
    return out


def lift(L: torch.Tensor, X: torch.Tensor, plan: Plan, use_kernels: bool = True) -> torch.Tensor:
    """``L @ X`` in ``plan``'s order (a :func:`lift_plan`) for L f32 [S, S]
    (contiguous) and X f32 [S, D] with unit column stride -> f32 [S, D]. CUDA tensors
    launch ``lift_kernel`` (unless ``use_kernels=False``); CPU tensors take
    :func:`contract_ref`."""
    if L.device.type == "cpu" or not use_kernels:
        return contract_ref(L, X, plan)
    _native.require(L, "L", _F32)
    _rows(X, "X")
    S, D = X.shape
    if tuple(L.shape) != (S, S):
        raise ValueError(f"lift: expected L of shape {(S, S)}, got {tuple(L.shape)}")
    tab = _lift_table(plan, str(X.device))
    out = torch.empty((S, D), dtype=_F32, device=X.device)
    rc = _native.library().tt_contract_lift(L.data_ptr(), X.data_ptr(), tab.data_ptr(), out.data_ptr(), S, D,
                                            X.stride(0), tab.numel(), plan.lanes,
                                            plan.split if plan.alt is not None else D, _native.stream_ptr())
    _native.check(rc, "contract")
    _native.count_launch("contract")
    return out
