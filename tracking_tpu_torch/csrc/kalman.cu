// kalman_predict / kalman_update: the tracker's bank of K constant-velocity
// Kalman filters (state [K, 8], covariance [K, 8, 8]), one thread a track,
// the whole step in registers and local memory.
//
// Replaces no TPU kernel: the JAX package's filter is einsums and
// jnp.linalg.inv (tracking_tpu/track/kalman.py:60-82), which the port ran as
// cuBLAS products and cuSOLVER's batched inverse, in other orders of
// summation than XLA:CPU's. This kernel computes the step in the reference's
// orders (track/kalman.py's module note has them), so the card's tracks equal
// the CPU's and the JAX package's bit for bit:
//   - an einsum's dot of 4 or 8 terms: four lanes (term k in lane k mod 4),
//     each an FMA chain, then (l0 + l1) + (l2 + l3), + 0 (kdot);
//   - K y: one FMA chain from +0 a row;
//   - the inverse: OpenBLAS's getf2 (left-looking, IAMAX pivots, the column
//     scaled by the pivot's f32 reciprocal) and its two trsm solves
//     (right-looking, times the diagonal's f32 reciprocal, c - x*l fused).
// The build's -fmad=false keeps every other product and sum rounded on its
// own; __fmaf_rn stands exactly where the reference fuses.
//
// Bound on the H100: latency. An update reads and writes about 19 KB for the
// tracker's 32 tracks (~0.006 us of memory time) and does ~110 K operations
// (~0.002 us); what it costs is one launch and one thread's serial chain of
// dependent operations (the inverse's ~60 steps, each a few cycles of
// latency): ~0.01 ms of device time on an H100. Its two launches a frame
// take the place of the library's 36 (cuBLAS products and split-K
// reductions, cuSOLVER's batched LU, row swaps and triangular solves, the
// selects): a tracker step on an H100 ran 481 device operations with them
// and 515 without.
#include <float.h>

#include "common.cuh"

#define KF_X 8
#define KF_Z 4

// Σ_k a[k * sa] · b[k * sb], n = 4 or 8, in Eigen's lane order.
__device__ __forceinline__ float kdot(const float* a, int sa, const float* b, int sb, int n) {
  float l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    l[j] = a[j * sa] * b[j * sb];
    if (n > 4) l[j] = __fmaf_rn(a[(j + 4) * sa], b[(j + 4) * sb], l[j]);
  }
  return ((l[0] + l[1]) + (l[2] + l[3])) + 0.0f;
}

// jnp.linalg.inv of a 4 x 4 f32 matrix as jaxlib's LAPACK (OpenBLAS) computes it.
__device__ void inverse4(float a[4][4], float x[4][4]) {
  int perm[4] = {0, 1, 2, 3};
  for (int j = 0; j < 4; ++j) {
    for (int i = 1; i < j; ++i) {  // forward substitution: a dot, terms in reverse order
      float acc = 0.0f;
      for (int k = i - 1; k >= 0; --k) acc = __fmaf_rn(a[i][k], a[k][j], acc);
      a[i][j] = a[i][j] - acc;
    }
    if (j > 0) {
      for (int r = j; r < 4; ++r) {  // the matrix-vector product with L's block
        float acc = 0.0f;
        for (int k = 0; k < j; ++k) acc = __fmaf_rn(a[r][k], a[k][j], acc);
        a[r][j] = a[r][j] - acc;
      }
    }
    int jp = j;  // IAMAX: the first largest |a|
    float best = fabsf(a[j][j]);
    for (int r = j + 1; r < 4; ++r) {
      const float v = fabsf(a[r][j]);
      if (v > best) {
        best = v;
        jp = r;
      }
    }
    if (jp != j) {
      for (int c = 0; c < 4; ++c) {
        const float t = a[j][c];
        a[j][c] = a[jp][c];
        a[jp][c] = t;
      }
      const int t = perm[j];
      perm[j] = perm[jp];
      perm[jp] = t;
    }
    const float piv = a[j][j];
    if (fabsf(piv) >= FLT_MIN) {
      const float r = 1.0f / piv;
      for (int i = j + 1; i < 4; ++i) a[i][j] = a[i][j] * r;
    } else if (piv != 0.0f) {
      for (int i = j + 1; i < 4; ++i) a[i][j] = a[i][j] / piv;
    }
  }
  for (int i = 0; i < 4; ++i)
    for (int c = 0; c < 4; ++c) x[i][c] = perm[i] == c ? 1.0f : 0.0f;
  for (int i = 0; i < 4; ++i)
    for (int k = i + 1; k < 4; ++k)
      for (int c = 0; c < 4; ++c) x[k][c] = __fmaf_rn(-x[i][c], a[k][i], x[k][c]);
  for (int i = 3; i >= 0; --i) {
    const float r = 1.0f / a[i][i];
    for (int c = 0; c < 4; ++c) x[i][c] = x[i][c] * r;
    for (int k = 0; k < i; ++k)
      for (int c = 0; c < 4; ++c) x[k][c] = __fmaf_rn(-x[i][c], a[k][i], x[k][c]);
  }
}

__global__ void __launch_bounds__(32) kalman_predict_kernel(const float* __restrict__ xs, const float* __restrict__ Ps,
                                                            const float* __restrict__ F, const float* __restrict__ Q,
                                                            float* xo, float* Po, int K) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= K) return;
  const float* x = xs + t * KF_X;
  const float* P = Ps + t * KF_X * KF_X;
  float FP[KF_X][KF_X];
  for (int i = 0; i < KF_X; ++i) {
    xo[t * KF_X + i] = kdot(F + i * KF_X, 1, x, 1, KF_X);
    for (int l = 0; l < KF_X; ++l) FP[i][l] = kdot(F + i * KF_X, 1, P + l, KF_X, KF_X);
  }
  for (int i = 0; i < KF_X; ++i)
    for (int m = 0; m < KF_X; ++m)
      Po[(t * KF_X + i) * KF_X + m] = kdot(FP[i], 1, F + m * KF_X, 1, KF_X) + Q[i * KF_X + m];
}

__global__ void __launch_bounds__(32) kalman_update_kernel(const float* __restrict__ xs, const float* __restrict__ Ps,
                                                           const float* __restrict__ zs, const bool* __restrict__ gate,
                                                           const float* __restrict__ H, const float* __restrict__ R,
                                                           float* xo, float* Po, int K) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= K) return;
  const float* x = xs + t * KF_X;
  const float* P = Ps + t * KF_X * KF_X;
  if (!gate[t]) {  // the slot passes through, bit for bit
    for (int i = 0; i < KF_X; ++i) xo[t * KF_X + i] = x[i];
    for (int i = 0; i < KF_X * KF_X; ++i) Po[t * KF_X * KF_X + i] = P[i];
    return;
  }
  float y[KF_Z], HP[KF_Z][KF_X], S[KF_Z][KF_Z], Si[KF_Z][KF_Z], PHt[KF_X][KF_Z], G[KF_X][KF_Z], IKH[KF_X][KF_X];
  for (int i = 0; i < KF_Z; ++i) {
    y[i] = zs[t * KF_Z + i] - kdot(x, 1, H + i * KF_X, 1, KF_X);
    for (int l = 0; l < KF_X; ++l) HP[i][l] = kdot(H + i * KF_X, 1, P + l, KF_X, KF_X);
  }
  for (int i = 0; i < KF_Z; ++i)
    for (int m = 0; m < KF_Z; ++m) S[i][m] = kdot(HP[i], 1, H + m * KF_X, 1, KF_X) + R[i * KF_Z + m];
  inverse4(S, Si);
  for (int i = 0; i < KF_X; ++i)
    for (int m = 0; m < KF_Z; ++m) PHt[i][m] = kdot(P + i * KF_X, 1, H + m * KF_X, 1, KF_X);
  for (int i = 0; i < KF_X; ++i) {
    for (int n = 0; n < KF_Z; ++n) G[i][n] = kdot(PHt[i], 1, &Si[0][n], KF_Z, KF_Z);
    float acc = 0.0f;  // K y: XLA's row-major matrix-vector emitter
    for (int k = 0; k < KF_Z; ++k) acc = __fmaf_rn(G[i][k], y[k], acc);
    xo[t * KF_X + i] = x[i] + acc;
  }
  for (int i = 0; i < KF_X; ++i)
    for (int m = 0; m < KF_X; ++m) IKH[i][m] = (i == m ? 1.0f : 0.0f) - kdot(G[i], 1, H + m, KF_X, KF_Z);
  for (int i = 0; i < KF_X; ++i)
    for (int m = 0; m < KF_X; ++m) Po[(t * KF_X + i) * KF_X + m] = kdot(IKH[i], 1, P + m, KF_X, KF_X);
}

TT_EXPORT int tt_kalman_predict(const void* x, const void* P, const void* F, const void* Q, void* xo, void* Po, int K,
                                void* stream_) {
  if (K < 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;
  kalman_predict_kernel<<<tt_blocks(K, 32), 32, 0, static_cast<cudaStream_t>(stream_)>>>(
      static_cast<const float*>(x), static_cast<const float*>(P), static_cast<const float*>(F),
      static_cast<const float*>(Q), static_cast<float*>(xo), static_cast<float*>(Po), K);
  return (int)cudaGetLastError();
}

TT_EXPORT int tt_kalman_update(const void* x, const void* P, const void* z, const void* gate, const void* H,
                               const void* R, void* xo, void* Po, int K, void* stream_) {
  if (K < 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;
  kalman_update_kernel<<<tt_blocks(K, 32), 32, 0, static_cast<cudaStream_t>(stream_)>>>(
      static_cast<const float*>(x), static_cast<const float*>(P), static_cast<const float*>(z),
      static_cast<const bool*>(gate), static_cast<const float*>(H), static_cast<const float*>(R),
      static_cast<float*>(xo), static_cast<float*>(Po), K);
  return (int)cudaGetLastError();
}
