// resize_bilinear: one contraction of jax.image.resize's bilinear resize,
// out[i, j] = sum_k W[k, i] * X[k, j], a thread an output element.
//
// Replaces no TPU kernel: the JAX package calls jax.image.resize
// (tracking_tpu/bgs/lbp_mrf.py:377, LbpMrf's 24 x 32 scene-cut grid;
// tracking_tpu/bgs/multicue.py:690, MultiCue's enlarge), an einsum that
// XLA:CPU runs as two dots. The port ran them as cuBLAS products, whose sums
// are in another order than XLA:CPU's. Here each output is summed in
// XLA:CPU's order (ops/resize.py's module note): over its band of nonzero
// weights [lo[i], hi[i]], one FMA chain from +0 a block of kc inputs
// (absolute k / kc), each block's sum added to the output in order. The
// build's -fmad=false keeps the block additions unfused.
//
// Bound on the H100: bytes. The grid's row contraction reads the 720 x 1280
// f32 plane once (3.7 MB, ~1.1 us at 3.35 TB/s); a thread reads its ~61
// band rows of one column, the warp's 32 neighbouring columns coalesced,
// and the other outputs of a column (24 rows of the grid) read overlapping
// bands from L2. The column contraction is 768 outputs of ~81 terms.
#include "common.cuh"

__global__ void resize_contract_kernel(const float* __restrict__ W, const float* __restrict__ X,
                                       const int* __restrict__ lo, const int* __restrict__ hi, float* out, int P,
                                       int Q, int kc, int ws, int sxk, int sxq, int sop, int soq) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)P * Q) return;
  const int i = (int)(t / Q), j = (int)(t % Q);
  const int k0 = lo[i], k1 = hi[i];
  float c = 0.0f, acc = 0.0f;
  int blk = k0 / kc;
  for (int k = k0; k <= k1; ++k) {
    if (k / kc != blk) {
      c = c + acc;
      acc = 0.0f;
      blk = k / kc;
    }
    acc = __fmaf_rn(W[(long long)k * ws + i], X[(long long)k * sxk + (long long)j * sxq], acc);
  }
  out[(long long)i * sop + (long long)j * soq] = c + acc;
}

TT_EXPORT int tt_resize_contract(const void* W, const void* X, const void* lo, const void* hi, void* out, int P, int Q,
                                 int kc, int ws, int sxk, int sxq, int sop, int soq, void* stream_) {
  if (P < 0 || Q < 0 || kc <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)P * Q;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  resize_contract_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, static_cast<cudaStream_t>(stream_)>>>(
      static_cast<const float*>(W), static_cast<const float*>(X), static_cast<const int*>(lo),
      static_cast<const int*>(hi), static_cast<float*>(out), P, Q, kc, ws, sxk, sxq, sop, soq);
  return (int)cudaGetLastError();
}
