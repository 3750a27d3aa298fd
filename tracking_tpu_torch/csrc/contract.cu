// contract: XLA:CPU's f32 dot, out[i, j] = sum_k A[i, k] * B[k, j], in the
// order of additions that ops/contract.py's Plan lays out (the module note
// there says where each order comes from). Two launches a call:
//   1. contract_chains_kernel, a thread per (chain, i, j): one FMA chain
//      from +0 over the chain's k (k0, k0 + step, ...; count terms), only
//      where row i's band [lo_i, hi_i] holds k when a band is given, into
//      parts[chain][i][j]. A chain is a depth block, or a lane of one (the
//      block's terms k = l mod 2 or 4), or its tail; a chain whose flag is
//      off (a lane plan's tail, a narrow last panel) adds rounded products.
//   2. contract_combine_kernel, a thread an output: each block's sum from
//      its chains (lanes as l0 + l1 or ((l0 + l1) + (l2 + l3)), then the tail), then the
//      blocks added in order, or in Eigen's tree of its sharded contraction
//      (ranges of 4 as (b0 + b1) + (b2 + b3), a short range in order; then
//      the ranges' sums into the first, three at a time as (r0 + r1) + (r2 +
//      r3), the rest in order).
// The chains, blocks and column groups come as int32 tables (tc: k0, step,
// count, group, fused of each chain; tb: first chain, chain count, group of each
// block); columns j < split take group 0, the others group 1.
//
// Replaces no TPU kernel: the JAX package calls jax.image.resize
// (tracking_tpu/bgs/lbp_mrf.py:377, tracking_tpu/bgs/multicue.py:690, two
// dots) and Eigenbackground's Gram product and lift (tracking_tpu/bgs/
// eigenbackground.py:70 and :74), XLA dots that XLA:CPU hands to Eigen.
// The build's -fmad=false keeps every addition unfused; __fmaf_rn is the
// chains' FMA.
//
// Bound on the H100: bytes for the resize (each operand read once); for the
// Gram product the chains read A and B once each from L2 (the 20 x 20
// outputs share them) and the latency of a 1,024-step FMA chain.
#include "common.cuh"

__global__ void contract_chains_kernel(const float* __restrict__ A, const float* __restrict__ B,
                                       const int* __restrict__ lo, const int* __restrict__ hi,
                                       const int* __restrict__ tc, float* __restrict__ parts, int P, int Q, int C,
                                       int sai, int sak, int sbk, int sbj, int split) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)C * P * Q) return;
  const int j = (int)(t % Q);
  const int i = (int)((t / Q) % P);
  const int c = (int)(t / ((long long)P * Q));
  const int k0 = tc[c], step = tc[C + c], count = tc[2 * C + c], group = tc[3 * C + c], fused = tc[4 * C + c];
  if ((group == 0) != (j < split)) return;
  const int blo = lo ? lo[i] : 0, bhi = hi ? hi[i] : 0x7fffffff;
  float acc = 0.0f;
  for (int s = 0; s < count; ++s) {
    const int k = k0 + s * step;
    if (k < blo) continue;
    if (k > bhi) break;
    const float a = A[(long long)i * sai + (long long)k * sak], b = B[(long long)k * sbk + (long long)j * sbj];
    acc = fused ? __fmaf_rn(a, b, acc) : acc + a * b;  // -fmad=false: the product is rounded
  }
  parts[t] = acc;
}

__device__ __forceinline__ float block_sum(const float* __restrict__ parts, const int* __restrict__ tb, int NB, int b,
                                           long long o, long long PQ, int lanes) {
  const int f = tb[b], n = tb[NB + b];
  if (lanes == 1) return parts[f * PQ + o];
  float s = parts[f * PQ + o] + parts[(f + 1) * PQ + o];
  if (lanes == 4) s = s + (parts[(f + 2) * PQ + o] + parts[(f + 3) * PQ + o]);
  if (n > lanes) s = s + parts[(f + lanes) * PQ + o];
  return s;
}

__device__ __forceinline__ float range_sum(const float* __restrict__ parts, const int* __restrict__ tb, int NB,
                                           int b0, int nb, int r, long long o, long long PQ, int lanes) {
  const int first = b0 + 4 * r, len = min(4, nb - 4 * r);
  if (len == 4)
    return (block_sum(parts, tb, NB, first, o, PQ, lanes) + block_sum(parts, tb, NB, first + 1, o, PQ, lanes)) +
           (block_sum(parts, tb, NB, first + 2, o, PQ, lanes) + block_sum(parts, tb, NB, first + 3, o, PQ, lanes));
  float s = block_sum(parts, tb, NB, first, o, PQ, lanes);
  for (int q = 1; q < len; ++q) s = s + block_sum(parts, tb, NB, first + q, o, PQ, lanes);
  return s;
}

__global__ void contract_combine_kernel(const float* __restrict__ parts, const int* __restrict__ tb, float* out,
                                        int P, int Q, int NB, int soi, int soj, int lanes, int tree, int split) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (long long)P * Q) return;
  const int i = (int)(o / Q), j = (int)(o % Q);
  const int g = j < split ? 0 : 1;
  int b0 = 0, nb = 0;  // the group's blocks are contiguous in the table
  for (int b = 0; b < NB; ++b) {
    if (tb[2 * NB + b] == g) {
      if (nb == 0) b0 = b;
      ++nb;
    }
  }
  const long long PQ = (long long)P * Q;
  float acc;
  if (!tree) {
    acc = 0.0f;
    for (int b = b0; b < b0 + nb; ++b) acc = acc + block_sum(parts, tb, NB, b, o, PQ, lanes);
  } else {
    const int nr = (nb + 3) / 4;
    acc = range_sum(parts, tb, NB, b0, nb, 0, o, PQ, lanes);
    int r = 1;
    for (; r + 2 < nr; r += 3) {
      const float x = range_sum(parts, tb, NB, b0, nb, r, o, PQ, lanes);
      const float y = range_sum(parts, tb, NB, b0, nb, r + 1, o, PQ, lanes);
      const float z = range_sum(parts, tb, NB, b0, nb, r + 2, o, PQ, lanes);
      acc = (acc + x) + (y + z);
    }
    for (; r < nr; ++r) acc = acc + range_sum(parts, tb, NB, b0, nb, r, o, PQ, lanes);
  }
  out[(long long)i * soi + (long long)j * soj] = acc;
}

TT_EXPORT int tt_contract(const void* A, const void* B, const void* lo, const void* hi, const void* tc, const void* tb,
                          void* parts, void* out, int P, int Q, int C, int NB, int sai, int sak, int sbk, int sbj,
                          int soi, int soj, int lanes, int tree, int split, void* stream_) {
  if (P < 0 || Q < 0 || C <= 0 || NB <= 0 || (lanes != 1 && lanes != 2 && lanes != 4))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)P * Q;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int threads = 256;
  const long long nc = n * C;
  contract_chains_kernel<<<(unsigned)((nc + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(B), static_cast<const int*>(lo),
      static_cast<const int*>(hi), static_cast<const int*>(tc), static_cast<float*>(parts), P, Q, C, sai, sak, sbk,
      sbj, split);
  contract_combine_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const float*>(parts), static_cast<const int*>(tb), static_cast<float*>(out), P, Q, NB, soi, soj,
      lanes, tree, split);
  return (int)cudaGetLastError();
}
