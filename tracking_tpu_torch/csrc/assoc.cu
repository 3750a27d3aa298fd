// greedy_assign: greedy min-cost track<->blob assignment on a gated [K, B]
// f32 cost matrix: take the global minimum (ties to the lowest flat index),
// assign that pair, mask its row and column, until the minimum is gated
// (>= 1e9) or min(K, B) pairs are made.
//
// Replaces tracking_tpu/ops/pallas_assoc.py:greedy_assign_pallas, which runs
// the whole loop in one TPU kernel on the VMEM-resident matrix.
//
// Bound on the H100: one empty kernel's device time (0.001 ms, PERF.md
// section 6). The matrix is 8 KB at the default 32 tracks x 64 blobs and
// the tracker's loop makes a few pairs, so what a call costs is latency: the
// launch, one read of the matrix and the loop's serial steps. The first
// design ran every iteration as a reduction of one block of 1,024 threads -
// three __syncthreads, thread 0 folding the 32 warps' partials, the row and
// column masks written by the block: 0.014 ms of device time on the
// tracker's matrix (PERF.md section 6). Here:
//   1. the block's warps read the matrix once, a row a warp at a time
//      (coalesced), store each cell's order key in shared memory at the odd
//      row stride B | 1 (a lane's row scan below then hits another bank than
//      its neighbours') and reduce each row's minimum and its lowest column
//      with two __reduce_min_sync; one __syncthreads. A row whose minimum is
//      gated is done: rescans only remove columns, so it is never chosen;
//   2. warp 0 alone runs the loop, with no block barrier. Lane l owns rows
//      l, l + 32, ... Each iteration: the lane's least row minimum; the
//      warp's least key, then the least row among the lanes at that key (two
//      __reduce_min_sync) - the least (value, flat index), since a row's
//      minimum holds its lowest column; the owner marks its row done and
//      lane 0 marks the column taken in a shared bitmask; the rows whose
//      minimum sat in that column are rescanned, skipping taken columns: up
//      to ASSIGN_COOP_MAX of a 32-row group one after another by the whole
//      warp (a column a lane, two __reduce_min_sync), more by their own
//      lanes at once (row_min). Variants timed beside this one (script not
//      committed) lost: rescans by the rows' own lanes only, on the tracker's
//      matrix and on random ones; rescans by the whole warp only, where every
//      row's minimum sits in the taken column;
//   3. assign and taken are written once, at the end.
// Order key: a value's bits mapped so that unsigned order is float order,
// with -0 as +0 (they compare equal, so the flat index decides) and NaN
// above every number (never chosen, as the first design never chose it).
#include "common.cuh"

#define ASSIGN_BIG 1e9f
#define ASSIGN_MAX_CELLS 4096         // ops/assoc.py MAX_CELLS; row and column indices fit 12 bits
#define ASSIGN_DONE 0xFFFFFFFFu       // the key of a row that is done or has no open cell
#define ASSIGN_DONE64 0xFFFFFFFFFFFFFFFFull
#define ASSIGN_COOP_MAX 6              // rows of a 32-row group the whole warp rescans; more: a lane each

__device__ __forceinline__ unsigned cost_key(float v) {
  if (isnan(v)) return ASSIGN_DONE;
  const unsigned u = __float_as_uint(v + 0.0f);  // -0 + 0 = +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The least (key, column) of a row's open columns, by one lane: four minima
// in flight over the columns in order.
__device__ __forceinline__ unsigned long long row_min(const unsigned* row, const unsigned* tbits, int B) {
  unsigned long long acc[4] = {ASSIGN_DONE64, ASSIGN_DONE64, ASSIGN_DONE64, ASSIGN_DONE64};
  for (int w0 = 0; w0 < B; w0 += 32) {
    const unsigned open = ~tbits[w0 >> 5];
    const int n = min(32, B - w0);
    for (int i = 0; i < n; i += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b = w0 + i + u;
        if (i + u < n && ((open >> (i + u)) & 1u)) acc[u] = min(acc[u], (unsigned long long)row[b] << 32 | b);
      }
    }
  }
  return min(min(acc[0], acc[1]), min(acc[2], acc[3]));
}

// Dynamic shared memory, in 4-byte words: the keys [K][B | 1], each row's
// minimum key, its column and its assignment [K], the taken bitmask.
__host__ __device__ constexpr int assign_smem_words(int K, int B) { return K * (B | 1) + 3 * K + (B + 31) / 32; }

__global__ void __launch_bounds__(1024) greedy_assign_kernel(const float* __restrict__ cost_in, int* assign,
                                                             bool* taken, int K, int B) {
  extern __shared__ unsigned sm[];
  const int S = B | 1;
  unsigned* key = sm;
  unsigned* rkey = key + K * S;
  int* rcol = reinterpret_cast<int*>(rkey + K);
  int* asg = rcol + K;
  unsigned* tbits = reinterpret_cast<unsigned*>(asg + K);
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const unsigned gate = cost_key(ASSIGN_BIG);  // a row whose minimum reaches it is never chosen: done

  // -- 1. keys and row minima, the whole block ---------------------------------
  for (int k = warp; k < K; k += nwarps) {
    unsigned best = ASSIGN_DONE, bc = ASSIGN_DONE;
    for (int b = lane; b < B; b += 32) {
      const unsigned kv = cost_key(cost_in[k * B + b]);
      key[k * S + b] = kv;
      if (kv < best) {
        best = kv;
        bc = b;
      }
    }
    const unsigned m = __reduce_min_sync(full, best);
    const unsigned mc = __reduce_min_sync(full, best == m ? bc : ASSIGN_DONE);
    if (lane == 0) {
      rkey[k] = m >= gate ? ASSIGN_DONE : m;
      rcol[k] = (int)mc;
    }
  }
  for (int k = t; k < K; k += blockDim.x) asg[k] = -1;
  for (int i = t; i < (B + 31) / 32; i += blockDim.x) tbits[i] = 0;
  __syncthreads();
  if (warp != 0) return;

  // -- 2. the loop, one warp; rkey, rcol and asg of a row only in its lane -------
  const int iters = K < B ? K : B;
  for (int it = 0; it < iters; ++it) {
    unsigned best = ASSIGN_DONE, bkb = ASSIGN_DONE;
    for (int k = lane; k < K; k += 32) {
      const unsigned kv = rkey[k];
      if (kv < best) {
        best = kv;
        bkb = (unsigned)k << 12 | (unsigned)rcol[k];
      }
    }
    const unsigned m = __reduce_min_sync(full, best);
    if (m >= gate) break;  // the same decision in every lane
    const unsigned kb = __reduce_min_sync(full, best == m ? bkb : ASSIGN_DONE);
    const int kk = (int)(kb >> 12), bb = (int)(kb & 4095u);
    if (lane == (kk & 31)) {
      rkey[kk] = ASSIGN_DONE;
      asg[kk] = bb;
    }
    if (lane == 0) tbits[bb >> 5] |= 1u << (bb & 31);
    __syncwarp();
    for (int g = 0; g < K; g += 32) {  // the rows whose minimum sat in column bb, 32 rows at a time
      const int k = g + lane;
      const unsigned need = __ballot_sync(full, k < K && rkey[k] != ASSIGN_DONE && rcol[k] == bb);
      unsigned long long v = ASSIGN_DONE64;  // the new (key, column) minimum of this lane's row
      if (__popc(need) > ASSIGN_COOP_MAX) {  // many: each lane rescans its own row
        if ((need >> lane) & 1u) v = row_min(key + k * S, tbits, B);
      } else {  // few: the whole warp rescans each row, a column a lane
        for (unsigned rest = need; rest; rest &= rest - 1) {
          const int r = g + __ffs(rest) - 1;
          unsigned long long u = ASSIGN_DONE64;
          for (int b = lane; b < B; b += 32)
            if (!((tbits[b >> 5] >> lane) & 1u)) u = min(u, (unsigned long long)key[r * S + b] << 32 | b);
          const unsigned hi = __reduce_min_sync(full, (unsigned)(u >> 32));
          const unsigned lo = __reduce_min_sync(full, (unsigned)(u >> 32) == hi ? (unsigned)u : ASSIGN_DONE);
          if (r == k) v = (unsigned long long)hi << 32 | lo;
        }
      }
      if ((need >> lane) & 1u) {
        rkey[k] = (unsigned)(v >> 32) >= gate ? ASSIGN_DONE : (unsigned)(v >> 32);
        rcol[k] = (int)(v & 0xFFFFFFFFu);
      }
    }
    __syncwarp();
  }

  // -- 3. the outputs -----------------------------------------------------------
  for (int k = lane; k < K; k += 32) assign[k] = asg[k];
  for (int b = lane; b < B; b += 32) taken[b] = ((tbits[b >> 5] >> (b & 31)) & 1u) != 0;
}

TT_EXPORT int tt_greedy_assign(const void* cost, void* assign, void* taken, int K, int B, void* stream_) {
  if (K < 0 || B < 0 || (long long)K * B > ASSIGN_MAX_CELLS || K > ASSIGN_MAX_CELLS || B > ASSIGN_MAX_CELLS)
    return (int)cudaErrorInvalidValue;
  // the dynamic shared memory the largest matrix needs (K * (B | 1) <= 2 * MAX_CELLS), set once
  static const cudaError_t attr =
      cudaFuncSetAttribute(greedy_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           4 * (2 * ASSIGN_MAX_CELLS + 3 * ASSIGN_MAX_CELLS + ASSIGN_MAX_CELLS / 32));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int warps = K < 1 ? 1 : (K < 32 ? K : 32);  // a row a warp in step 1
  greedy_assign_kernel<<<1, 32 * warps, 4 * assign_smem_words(K, B), stream>>>(
      static_cast<const float*>(cost), static_cast<int*>(assign), static_cast<bool*>(taken), K, B);
  return (int)cudaGetLastError();
}
