// greedy_assign: greedy min-cost track<->blob assignment on a gated [K, B]
// f32 cost matrix: take the global minimum (ties to the lowest flat index),
// assign that pair, mask its row and column, until the minimum is gated
// (>= 1e9) or min(K, B) pairs are made.
//
// Replaces tracking_tpu/ops/pallas_assoc.py:greedy_assign_pallas, which runs
// the whole loop in one TPU kernel on the VMEM-resident matrix. Here: one
// thread block holds the matrix in shared memory (2048 cells at the default
// 32 tracks x 64 blobs); each iteration is one block reduction over
// (value, flat index) pairs ordered lexicographically - the minimum value,
// then the lowest index among the cells at that value - and a row and column
// mask.
//
// Bound on the H100: launch latency and the block's barriers (at most
// min(K, B) iterations of two __syncthreads each); the matrix is 8 KB.
#include "common.cuh"

#define ASSIGN_BIG 1e9f

__global__ void greedy_assign_kernel(const float* cost_in, int* assign, bool* taken, int K, int B) {
  extern __shared__ float cost[];
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  __shared__ float best_v;
  __shared__ int best_i;
  const int n = K * B, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nt + 31) >> 5;
  for (int i = tid; i < n; i += nt) cost[i] = cost_in[i];
  for (int k = tid; k < K; k += nt) assign[k] = -1;
  for (int b = tid; b < B; b += nt) taken[b] = false;
  __syncthreads();
  const int iters = K < B ? K : B;
  for (int it = 0; it < iters; ++it) {
    float v = INFINITY;
    int idx = n;
    for (int i = tid; i < n; i += nt) {
      float c = cost[i];
      if (c < v || (c == v && i < idx)) { v = c; idx = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, v, off);
      int oi = __shfl_down_sync(0xffffffffu, idx, off);
      if (ov < v || (ov == v && oi < idx)) { v = ov; idx = oi; }
    }
    if (lane == 0) { warp_v[warp] = v; warp_i[warp] = idx; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < nwarps; ++w) {
        if (warp_v[w] < v || (warp_v[w] == v && warp_i[w] < idx)) { v = warp_v[w]; idx = warp_i[w]; }
      }
      best_v = v;
      best_i = idx;
    }
    __syncthreads();
    const float m = best_v;
    const int flat = best_i;
    if (!(m < ASSIGN_BIG)) break;  // the same decision in every thread
    const int k = flat / B, b = flat % B;
    if (tid == 0) { assign[k] = b; taken[b] = true; }
    for (int j = tid; j < B; j += nt) cost[k * B + j] = ASSIGN_BIG;
    for (int j = tid; j < K; j += nt) cost[j * B + b] = ASSIGN_BIG;
    __syncthreads();
  }
}

TT_EXPORT int tt_greedy_assign(const void* cost, void* assign, void* taken, int K, int B, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  int threads = 1024;
  size_t smem = sizeof(float) * (size_t)K * (size_t)B;
  greedy_assign_kernel<<<1, threads, smem, stream>>>(static_cast<const float*>(cost), static_cast<int*>(assign),
                                                     static_cast<bool*>(taken), K, B);
  return (int)cudaGetLastError();
}
