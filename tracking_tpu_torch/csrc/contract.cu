// contract: XLA:CPU's f32 dot, out[i, j] = sum_k A[i, k] * B[k, j], in the
// order of additions that ops/contract.py's Plan lays out (the module note
// there says where each order comes from). Three entry points:
//   - tt_contract (the resize's row and column contractions, with their
//     bands and Eigen's tree): contract_chains_kernel then
//     contract_combine_kernel, below;
//   - tt_contract_gram (Eigenbackground's Xc Xc^T): gram_block_kernel then
//     gram_combine_kernel, further below;
//   - tt_contract_lift (its evecs^T Xc): lift_kernel, one launch.
// The resize's pair:
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
// chains' FMA. Tensor cores cannot take these chains (an MMA rounds TF32
// or 16-bit inputs and accumulates in its own order): every kernel here
// runs on the CUDA cores.
//
// Bound on the H100: bytes for the resize (each operand read once; at 24 x
// 32 outputs its pair runs at the launch floor). The Gram product's and the
// lift's bounds are in their section's note.
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

// ---------------------------------------------------------------------------
// The Gram product Xc Xc^T and the lift evecs^T Xc (Eigenbackground's PCA),
// in the orders of ops/contract.py's gram_plan and lift_plan: the same
// chains from +0, lane joins, tails of rounded products and blocks added in
// order as the pair above, with no [chains, P, Q] buffer of chain sums.
//
// The Gram product (gram_block_kernel, then gram_combine_kernel): a CTA a
// depth block of the plan (a column group of CTAs where the triangle has
// more tile pairs than one CTA's threads). The block's [S, chunk] slab of
// Xc goes through a ring of two shared-memory stages filled by cp.async
// (16-byte copies where the rows are 16-byte aligned, D mod 4 = 0; 4-byte
// copies otherwise). Each thread owns one tile pair (bi <= bj) of T rows a
// side, rows b, b + nt, b + 2 nt, ... (nt = ceil(S / T)), and every lane of
// the plan for it: LANES x T x T independent FMA chains in registers, fed
// by float4 loads of its T rows of each side (a float4 is one step of 4
// lanes, or 2 of 2, or 4 of one chain). With rows nt apart, the rows that
// a warp's neighbouring tiles load are consecutive, and a stage row of
// (chunk + 4) floats puts consecutive rows on distinct 16-byte bank groups:
// no conflicts. A pair holds each unordered (i, j) of its rows once (the
// diagonal pair twice: it keeps r <= c) and stores it as the upper
// triangle's (min, max). The thread joins its lanes ((l0 + l1) + (l2 +
// l3)), adds the block's tail of rounded products (read from global
// memory: < LANES terms) and writes the block's sum of each output, packed.
// The second launch adds the blocks' sums in order from +0, a thread an
// output (32-64 loads in flight ahead of the dependent additions), and writes both
// triangles: fmaf(a, b, c) == fmaf(b, a, c) and a*b == b*a, so the lower
// triangle's chains are the upper's.
//
// The lift (lift_kernel, one launch): persistent CTAs, each walking slabs
// of W (64) columns of Xc (all S rows) through two shared-memory stages by
// cp.async, the next slab's copy in flight while the current one is used;
// the lift matrix transposed in shared memory (Lt[k][i], its float4 of 4
// rows a broadcast). A thread takes a 4 x 4 tile of outputs (4 rows, 4
// columns), each output's chains in registers in the plan's order: the
// column group's blocks (chains of the panel's depth, 1, 2 or 4 lanes over
// S with their tail, rounded products where the narrow last panel takes
// them), added in order from +0; the output written once.
//
// Bounds on the H100: the Gram product reads Xc once (bytes: 0.0165 ms at
// [20, 691,200], 0.211 at [64, 2,764,800]) and does S(S+1)/2 D FMAs (0.171
// ms at [64, 2,764,800]: comparable, so both the slab's copies and the FMA
// throughput matter; the float4 micro-tiles keep shared loads to 1 per 2-4
// FMAs); the blocks' ordered sum is a chain of one dependent addition a
// block per output (5,400 at [64, 2,764,800]), 2,080 outputs there: 65
// warps on the card, bound by the loads they keep in flight. The lift
// reads Xc once and writes its output once (0.132 ms at [20, 2,764,800],
// 0.423 at [64, 2,764,800]) and does S^2 D FMAs (0.342 at 64 rows), two
// float4 shared loads per 16.
// floats after a staged row: (CH + 4) / 4 is odd, so consecutive rows start on distinct 16-byte bank groups
#define GRAM_PAD 4
#define GRAM_THREADS 256  // tile pairs a CTA at most
#define LIFT_THREADS 256  // a CTA: 16 column tiles x up to 16 row tiles
#define LIFT_W 64  // a slab's columns

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src));
#else
  dst[0] = src[0], dst[1] = src[1], dst[2] = src[2], dst[3] = src[3];
#endif
}

__device__ __forceinline__ void cp_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

template <int N>
__device__ __forceinline__ void cp_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

template <int E>
__device__ __forceinline__ float f4(const float4& v) {
  return E == 0 ? v.x : E == 1 ? v.y : E == 2 ? v.z : v.w;
}

// rows [0, rows) of X, columns [k, k + len), into st[r * ld + c]; vec: X's
// rows and k 16-byte aligned
__device__ __forceinline__ void stage_slab(float* st, int ld, const float* X, long long ldx, int rows, int k, int len,
                                           bool vec) {
  const int q = vec ? len >> 2 : 0, rem = len - 4 * q;
  for (int e = threadIdx.x; e < rows * q; e += blockDim.x) {
    const int r = e / q, c = 4 * (e - r * q);
    cp_async16(st + r * ld + c, X + r * ldx + k + c);
  }
  for (int e = threadIdx.x; e < rows * rem; e += blockDim.x) {
    const int r = e / rem, c = 4 * q + (e - r * rem);
    cp_async4(st + r * ld + c, X + r * ldx + k + c);
  }
}

// one float4 of the slab: sub-step E (column 4q + E of the chunk) is lane E mod LANES
template <int T, int LANES, int E>
__device__ __forceinline__ void gram_step(float (&acc)[LANES][T][T], const float4 (&a)[T], const float4 (&b)[T]) {
#pragma unroll
  for (int r = 0; r < T; ++r)
#pragma unroll
    for (int c = 0; c < T; ++c) acc[E % LANES][r][c] = __fmaf_rn(f4<E>(a[r]), f4<E>(b[c]), acc[E % LANES][r][c]);
}

template <int T, int LANES>
__global__ void gram_block_kernel(const float* __restrict__ X, long long ldx, int S, int vec_ok,
                                  const int* __restrict__ blocks, int NB, int CH, float* __restrict__ partial) {
  extern __shared__ __align__(16) float gsm[];
  const int b = blockIdx.x, k0 = blocks[b], k1 = blocks[NB + b];
  const int n = k1 - k0, main_n = n - n % LANES;
  const int nt = (S + T - 1) / T, rows = nt * T, ld = CH + GRAM_PAD;
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = p < nt * (nt + 1) / 2;
  int bi = 0, bj = 0;
  if (live) {
    int q = p;
    while (q >= nt - bi) q -= nt - bi++;
    bj = bi + q;
  }
  float* stage0 = gsm;
  float* stage1 = gsm + rows * ld;
  for (int e = threadIdx.x; e < (rows - S) * ld; e += blockDim.x)  // padding rows: their outputs are dropped
    stage0[S * ld + e] = 0.0f, stage1[S * ld + e] = 0.0f;
  float acc[LANES][T][T];
#pragma unroll
  for (int l = 0; l < LANES; ++l)
#pragma unroll
    for (int r = 0; r < T; ++r)
#pragma unroll
      for (int c = 0; c < T; ++c) acc[l][r][c] = 0.0f;
  const bool vec = vec_ok && k0 % 4 == 0;
  const int nch = (main_n + CH - 1) / CH;
  if (nch > 0) stage_slab(stage0, ld, X, ldx, S, k0, min(CH, main_n), vec);
  cp_commit();
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch)
      stage_slab((ch & 1) ? stage0 : stage1, ld, X, ldx, S, k0 + (ch + 1) * CH, min(CH, main_n - (ch + 1) * CH), vec);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* st = (ch & 1) ? stage1 : stage0;
    const int len = min(CH, main_n - ch * CH), q4 = len >> 2;
    if (live) {
      const float* ar = st + bi * ld;  // rows bi, bi + nt, ...: consecutive tiles on distinct banks
      const float* br = st + bj * ld;
      for (int q = 0; q < q4; ++q) {
        float4 a[T], bv[T];
#pragma unroll
        for (int r = 0; r < T; ++r) a[r] = *reinterpret_cast<const float4*>(ar + r * nt * ld + 4 * q);
#pragma unroll
        for (int c = 0; c < T; ++c) bv[c] = *reinterpret_cast<const float4*>(br + c * nt * ld + 4 * q);
        gram_step<T, LANES, 0>(acc, a, bv);
        gram_step<T, LANES, 1>(acc, a, bv);
        gram_step<T, LANES, 2>(acc, a, bv);
        gram_step<T, LANES, 3>(acc, a, bv);
      }
      // the last chunk's last len mod 4 columns (len is a multiple of LANES): lane u mod LANES
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        if (4 * q4 + u < len) {
#pragma unroll
          for (int r = 0; r < T; ++r)
#pragma unroll
            for (int c = 0; c < T; ++c)
              acc[u % LANES][r][c] =
                  __fmaf_rn(ar[r * nt * ld + 4 * q4 + u], br[c * nt * ld + 4 * q4 + u], acc[u % LANES][r][c]);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  if (!live) return;
  const int U = S * (S + 1) / 2;
#pragma unroll
  for (int r = 0; r < T; ++r) {
#pragma unroll
    for (int c = 0; c < T; ++c) {
      const int i = bi + nt * r, j = bj + nt * c;  // G[i][j] == G[j][i]: stored as the upper one
      if (i >= S || j >= S || (bi == bj && r > c)) continue;
      float s = acc[0][r][c];
      if (LANES == 2) s = acc[0][r][c] + acc[LANES > 1 ? 1 : 0][r][c];
      if (LANES == 4)
        s = (acc[0][r][c] + acc[LANES > 1 ? 1 : 0][r][c]) + (acc[LANES > 2 ? 2 : 0][r][c] + acc[LANES > 3 ? 3 : 0][r][c]);
      if (n > main_n) {  // the block's tail chain of rounded products
        float t = 0.0f;
        for (int k = k0 + main_n; k < k1; ++k) t = __fadd_rn(t, __fmul_rn(X[i * ldx + k], X[j * ldx + k]));
        s = s + t;
      }
      const int lo = min(i, j), hi = max(i, j);
      partial[(long long)b * U + lo * (2 * S - lo + 1) / 2 + (hi - lo)] = s;
    }
  }
}

#define GRAM_INFLIGHT 32
// The blocks' sums of output u in order from +0: two register buffers of
// GRAM_INFLIGHT loads, one filling while the other is added, so that 32 to
// 64 loads a thread stay in flight ahead of the dependent additions.
__global__ void gram_combine_kernel(const float* __restrict__ partial, int NB, int S, float* __restrict__ out) {
  const int U = S * (S + 1) / 2;
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= U) return;
  int i = 0, q = u;
  while (q >= S - i) q -= S - i++;
  const int j = i + q;
  const float* p = partial + u;
  float acc = 0.0f, va[GRAM_INFLIGHT], vb[GRAM_INFLIGHT];
  const int whole = NB / GRAM_INFLIGHT;  // batches of GRAM_INFLIGHT blocks
  if (whole > 0) {
#pragma unroll
    for (int r = 0; r < GRAM_INFLIGHT; ++r) va[r] = p[(long long)r * U];
  }
  for (int t = 0; t < whole; t += 2) {
    if (t + 1 < whole) {
#pragma unroll
      for (int r = 0; r < GRAM_INFLIGHT; ++r) vb[r] = p[(long long)((t + 1) * GRAM_INFLIGHT + r) * U];
    }
#pragma unroll
    for (int r = 0; r < GRAM_INFLIGHT; ++r) acc = acc + va[r];
    if (t + 1 < whole) {
      if (t + 2 < whole) {
#pragma unroll
        for (int r = 0; r < GRAM_INFLIGHT; ++r) va[r] = p[(long long)((t + 2) * GRAM_INFLIGHT + r) * U];
      }
#pragma unroll
      for (int r = 0; r < GRAM_INFLIGHT; ++r) acc = acc + vb[r];
    }
  }
  for (int b = whole * GRAM_INFLIGHT; b < NB; ++b) acc = acc + p[(long long)b * U];
  out[i * S + j] = acc;
  out[j * S + i] = acc;
}

// one step of 4 x 4 chains at depth k: a float4 of 4 rows of Lt, one of 4 columns of the slab
template <bool FUSED>
__device__ __forceinline__ void lift_step(float (&acc)[4][4], const float4& a, const float4& x) {
  const float av[4] = {a.x, a.y, a.z, a.w}, xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[r][c] = FUSED ? __fmaf_rn(av[r], xv[c], acc[r][c]) : __fadd_rn(acc[r][c], __fmul_rn(av[r], xv[c]));
}

// the LANES chains of one block over k in [k0, k0 + main_n), lane l on k = k0 + l mod LANES
template <int LANES, bool FUSED>
__device__ __forceinline__ void lift_lanes(float (&acc)[LANES][4][4], const float* Lt, int ldt, const float* Xs, int ldx,
                                           int k0, int main_n) {
  for (int k = k0; k < k0 + main_n; k += LANES) {
#pragma unroll
    for (int l = 0; l < LANES; ++l)
      lift_step<FUSED>(acc[l], *reinterpret_cast<const float4*>(Lt + (k + l) * ldt),
                       *reinterpret_cast<const float4*>(Xs + (k + l) * ldx));
  }
}

template <int LANES>
__global__ void lift_kernel(const float* __restrict__ L, const float* __restrict__ X, long long ldx, int S, int D,
                            int vec_ok, const int* __restrict__ table, int ntab, int split, int W,
                            float* __restrict__ out) {
  extern __shared__ __align__(16) float lsm[];
  const int rows4 = (S + 3) / 4 * 4;
  float* Lt = lsm;                // [S][rows4]: Lt[k][i] = L[i][k]
  float* buf0 = Lt + S * rows4;   // two stages of [S][W]: a slab of the columns of Xc
  float* buf1 = buf0 + S * W;
  int* tab = reinterpret_cast<int*>(buf1 + S * W);
  const int nslabs = (D + W - 1) / W;
  int slab = blockIdx.x;
  if (slab < nslabs) stage_slab(buf0, W, X, ldx, S, slab * W, min(W, D - slab * W), vec_ok != 0);
  cp_commit();
  for (int e = threadIdx.x; e < ntab; e += blockDim.x) tab[e] = table[e];
  for (int e = threadIdx.x; e < S * rows4; e += blockDim.x) {
    const int k = e / rows4, i = e - k * rows4;
    Lt[e] = i < S ? L[i * S + k] : 0.0f;
  }
  const int ctn = W / 4, ct = threadIdx.x % ctn, rt = blockIdx.y * (blockDim.x / ctn) + threadIdx.x / ctn;
  const int c0 = 4 * ct;
  const bool rows_live = 4 * rt < S;
  const bool out_vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const float* lt = Lt + 4 * rt;
  for (int it = 0; slab < nslabs; ++it, slab += gridDim.x) {
    const int next = slab + gridDim.x;
    if (next < nslabs) stage_slab((it & 1) ? buf0 : buf1, W, X, ldx, S, next * W, min(W, D - next * W), vec_ok != 0);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int j0 = slab * W, w = min(W, D - j0);
    if (rows_live && c0 < w) {
      const float* xs = ((it & 1) ? buf1 : buf0) + c0;
      const int g = j0 + c0 >= split;
      const int nb0 = tab[0], nb = g ? tab[1] : nb0;
      const bool fused = tab[2 + g] != 0;
      const int* bl = tab + 4 + (g ? 2 * nb0 : 0);
      float o[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[r][c] = 0.0f;
      for (int bk = 0; bk < nb; ++bk) {
        const int k0 = bl[2 * bk], k1 = bl[2 * bk + 1], n = k1 - k0, main_n = n - n % LANES;
        float acc[LANES][4][4];
#pragma unroll
        for (int l = 0; l < LANES; ++l)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[l][r][c] = 0.0f;
        if (fused)
          lift_lanes<LANES, true>(acc, lt, rows4, xs, W, k0, main_n);
        else
          lift_lanes<LANES, false>(acc, lt, rows4, xs, W, k0, main_n);
        float tail[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) tail[r][c] = 0.0f;
        for (int k = k0 + main_n; k < k1; ++k)  // the block's tail chain: rounded products
          lift_step<false>(tail, *reinterpret_cast<const float4*>(lt + k * rows4),
                           *reinterpret_cast<const float4*>(xs + k * W));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float sm = acc[0][r][c];
            if (LANES == 2) sm = acc[0][r][c] + acc[LANES > 1 ? 1 : 0][r][c];
            if (LANES == 4)
              sm = (acc[0][r][c] + acc[LANES > 1 ? 1 : 0][r][c]) +
                   (acc[LANES > 2 ? 2 : 0][r][c] + acc[LANES > 3 ? 3 : 0][r][c]);
            if (n > main_n) sm = sm + tail[r][c];
            o[r][c] = o[r][c] + sm;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * rt + r;
        if (i >= S) break;
        float* dst = out + (long long)i * D + j0 + c0;
        if (out_vec && c0 + 4 <= w) {
          *reinterpret_cast<float4*>(dst) = make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c0 + c < w) dst[c] = o[r][c];
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
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

template <int T, int LANES>
static int launch_gram(const float* X, long long ldx, int S, int vec_ok, const int* blocks, int NB, int CH,
                       float* partial, int threads, int groups, size_t smem, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(gram_block_kernel<T, LANES>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  gram_block_kernel<T, LANES><<<dim3((unsigned)NB, (unsigned)groups), threads, smem, stream>>>(X, ldx, S, vec_ok, blocks,
                                                                                               NB, CH, partial);
  return (int)cudaGetLastError();
}

// Xc Xc^T: X [S, D] with row stride ldx (unit column stride), blocks int32
// [2, NB] (k0 row, k1 row: the plan's depth blocks, to D), partial f32
// [NB, S (S + 1) / 2], out f32 [S, S].
TT_EXPORT int tt_contract_gram(const void* X, const void* blocks, void* partial, void* out, int S, int ldx, int NB,
                               int lanes, void* stream_) {
  if (S <= 0 || NB <= 0 || (lanes != 1 && lanes != 2 && lanes != 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int T = lanes == 1 ? 4 : 2;
  const int nt = (S + T - 1) / T, pairs = nt * (nt + 1) / 2;
  const int threads = pairs < GRAM_THREADS ? (pairs + 31) / 32 * 32 : GRAM_THREADS;
  const int groups = (pairs + threads - 1) / threads;
  int CH = 256;  // a stage's columns: two stages of the slab in <= 48 KiB (several CTAs an SM)
  while (CH > 16 && 2u * nt * T * (CH + GRAM_PAD) * sizeof(float) > 48u * 1024u) CH /= 2;
  const size_t smem = 2u * nt * T * (CH + GRAM_PAD) * sizeof(float);
  if (smem > 227u * 1024u) return (int)cudaErrorInvalidValue;
  const int vec_ok = ldx % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const float* x = static_cast<const float*>(X);
  const int* bl = static_cast<const int*>(blocks);
  float* part = static_cast<float*>(partial);
  int rc;
  if (lanes == 1)
    rc = launch_gram<4, 1>(x, ldx, S, vec_ok, bl, NB, CH, part, threads, groups, smem, stream);
  else if (lanes == 2)
    rc = launch_gram<2, 2>(x, ldx, S, vec_ok, bl, NB, CH, part, threads, groups, smem, stream);
  else
    rc = launch_gram<2, 4>(x, ldx, S, vec_ok, bl, NB, CH, part, threads, groups, smem, stream);
  if (rc != (int)cudaSuccess) return rc;
  const int U = S * (S + 1) / 2;
  gram_combine_kernel<<<tt_blocks(U, 32), 32, 0, stream>>>(part, NB, S, static_cast<float*>(out));  // a warp an SM
  return (int)cudaGetLastError();
}

template <int LANES>
static int launch_lift(const float* L, const float* X, long long ldx, int S, int D, int vec_ok, const int* table,
                       int ntab, int split, int W, float* out, size_t smem, cudaStream_t stream) {
  const cudaError_t attr =
      cudaFuncSetAttribute(lift_kernel<LANES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int ctn = W / 4, nrt = (S + 3) / 4;
  const int rtn = min(nrt, LIFT_THREADS / ctn);
  const int threads = ctn * rtn, groups = (nrt + rtn - 1) / rtn;
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lift_kernel<LANES>, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // persistent CTAs: each walks the slabs blockIdx.x, + gridDim.x, ..., prefetching the next
  const int nslabs = (D + W - 1) / W;
  const int ctas = min(nslabs, max(1, per_sm * sms / groups));
  lift_kernel<LANES><<<dim3((unsigned)ctas, (unsigned)groups), threads, smem, stream>>>(L, X, ldx, S, D, vec_ok, table,
                                                                                     ntab, split, W, out);
  return (int)cudaGetLastError();
}

// evecs^T Xc: L [S, S] contiguous, X [S, D] with row stride ldx (unit column
// stride), table int32 [ntab]: the blocks of groups 0 (columns < split)
// and 1 (nb0, nb1, fused0, fused1, then k0, k1 of each block), out f32 [S, D].
TT_EXPORT int tt_contract_lift(const void* L, const void* X, const void* table, void* out, int S, int D, int ldx,
                               int ntab, int lanes, int split, void* stream_) {
  if (S <= 0 || D <= 0 || ntab < 4 || (lanes != 1 && lanes != 2 && lanes != 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int rows4 = (S + 3) / 4 * 4;
  int W = LIFT_W;  // a slab's columns: the widest whose two stages fit beside Lt
  auto bytes = [&](int w) { return (size_t)(S * rows4 + 2 * S * w) * sizeof(float) + (size_t)ntab * sizeof(int); };
  while (W > 4 && bytes(W) > 227u * 1024u) W /= 2;
  if (bytes(W) > 227u * 1024u) return (int)cudaErrorInvalidValue;
  const int vec_ok = ldx % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const float* l = static_cast<const float*>(L);
  const float* x = static_cast<const float*>(X);
  const int* tab = static_cast<const int*>(table);
  float* o = static_cast<float*>(out);
  if (lanes == 1) return launch_lift<1>(l, x, ldx, S, D, vec_ok, tab, ntab, split, W, o, bytes(W), stream);
  if (lanes == 2) return launch_lift<2>(l, x, ldx, S, D, vec_ok, tab, ntab, split, W, o, bytes(W), stream);
  return launch_lift<4>(l, x, ldx, S, D, vec_ok, tab, ntab, split, W, o, bytes(W), stream);
}
