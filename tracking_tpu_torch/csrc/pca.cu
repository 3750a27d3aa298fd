// pca_project: Eigenbackground's per-frame projection and reconstruction,
// recon = mean + basis^T (basis xc) with xc = flat - mean, in the orders of
// XLA:CPU's row-major matrix-vector emitter (ops/pca.py's module note):
//   1. pca_proj_kernel, a block a row i: proj = basis [E, D] . xc [D]. Its
//      thread l < 8 keeps lane l, an FMA chain from +0 over the columns d =
//      l (mod 8) below D8 = D - D mod 8, and thread 8 the tail d >= D8; then
//      row i's lanes are added in the tree of its tile of 8 rows,
//      ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7)) in a whole tile, ((0 + 4) + (2
//      + 6)) + ((1 + 5) + (3 + 7)) in the last partial one, plus the tail.
//   2. pca_recon_kernel, a thread a pixel value d: row d of basis^T [D, E]
//      times proj [E] the same way (lanes over e below E8, the tail e >= E8,
//      the tree of d's tile of 8 rows), added to mean[d].
// The build's -fmad=false keeps the tree's additions unfused.
//
// Replaces no TPU kernel: the JAX package's step (tracking_tpu/bgs/
// eigenbackground.py:89-90) is two XLA dots. Bound on the H100: each lane
// of the projection is a chain of D / 8 dependent FMAs (345,600 at 720p),
// so the projection is bound by latency, not by its 2 x 11 MB of reads.
#include "common.cuh"

__device__ __forceinline__ float lane_tree(const float* l, bool whole) {
  return whole ? ((l[0] + l[1]) + (l[2] + l[3])) + ((l[4] + l[5]) + (l[6] + l[7]))
               : ((l[0] + l[4]) + (l[2] + l[6])) + ((l[1] + l[5]) + (l[3] + l[7]));
}

// The projection, a block a row of the basis: its 8 lane chains and its tail
// read their terms from shared memory, while the block's other threads
// (the loaders) copy the next tile of ``tile`` columns of the row and of xc
// (two buffers, one barrier a tile; float4 loads where D and the pointers
// allow, 8 in flight a loader; the loaders in warps of their own). A chain
// keeps 8 steps' shared loads ahead of its FMAs. (On the H100, one block for
// all rows, its chains reading global memory, took 27.5 ms at the 360 x 640
// crop; with shared tiles but the loads of one SM, 2.9.)
#define PROJ_THREADS 256

__global__ void pca_proj_kernel(const float* __restrict__ basis, const float* __restrict__ xc,
                                float* __restrict__ proj, int E, int D, int tile, int vec) {
  extern __shared__ float buf[];  // 2 x 2 x (tile + 8): the row, then xc
  __shared__ float part[9];
  const int i = blockIdx.x, t = threadIdx.x;
  const int D8 = D - D % 8;
  const int ld = tile + 8, span = 2 * ld;
  const int nload = blockDim.x - 32;  // warps 1.. load; warp 0 holds the chains (a warp runs one path at a time)
  const float* row = basis + (long long)i * D;
  auto load = [&](int slot, int d0) {
    const int w = vec ? tile / 4 : tile, total = 2 * w;
    for (int q0 = t - 32; q0 < total; q0 += 8 * nload) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int q = q0 + u * nload, r = q / w, c = q % w;
        const float* src = r == 0 ? row : xc;
        if (q >= total) continue;
        if (vec) {
          const int d = d0 + 4 * c;
          if (d + 3 < D8) {
            v[u] = *reinterpret_cast<const float4*>(src + d);
          } else {
            v[u].x = d < D8 ? src[d] : 0.0f;
            v[u].y = d + 1 < D8 ? src[d + 1] : 0.0f;
            v[u].z = d + 2 < D8 ? src[d + 2] : 0.0f;
            v[u].w = d + 3 < D8 ? src[d + 3] : 0.0f;
          }
        } else {
          const int d = d0 + c;
          v[u].x = d < D8 ? src[d] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int q = q0 + u * nload, r = q / w, c = q % w;
        if (q >= total) continue;
        float* dst = buf + slot * span + r * ld;
        if (vec) {
          *reinterpret_cast<float4*>(dst + 4 * c) = v[u];
        } else {
          dst[c] = v[u].x;
        }
      }
    }
  };
  float acc = 0.0f;
  if (t >= 32) load(0, 0);
  __syncthreads();
  for (int k = 0, d0 = 0; d0 < D8; ++k, d0 += tile) {
    const int slot = k & 1;
    if (t >= 32) {
      if (d0 + tile < D8) load(slot ^ 1, d0 + tile);
    } else if (t < 8) {
      const float* b = buf + slot * span;
      const float* x = b + ld;
      const int n = min(tile, D8 - d0);
      int c = t;
      for (; c + 56 < n; c += 64) {
        float bv[8], xv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          bv[u] = b[c + 8 * u];
          xv[u] = x[c + 8 * u];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = __fmaf_rn(bv[u], xv[u], acc);
      }
      for (; c < n; c += 8) acc = __fmaf_rn(b[c], x[c], acc);
    }
    __syncthreads();
  }
  if (t == 8)
    for (int d = D8; d < D; ++d) acc = __fmaf_rn(row[d], xc[d], acc);
  if (t < 9) part[t] = acc;
  __syncthreads();
  if (t == 0) proj[i] = lane_tree(part, i < E - E % 8) + part[8];
}

__global__ void pca_recon_kernel(const float* __restrict__ basis, const float* __restrict__ proj,
                                 const float* __restrict__ mean, float* __restrict__ recon, int E, int D) {
  const long long d = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int E8 = E - E % 8;
  float lanes[8];
  for (int l = 0; l < 8; ++l) {
    float acc = 0.0f;
    for (int e = l; e < E8; e += 8) acc = __fmaf_rn(basis[(long long)e * D + d], proj[e], acc);
    lanes[l] = acc;
  }
  float tail = 0.0f;
  for (int e = E8; e < E; ++e) tail = __fmaf_rn(basis[(long long)e * D + d], proj[e], tail);
  recon[d] = mean[d] + (lane_tree(lanes, d < D - D % 8) + tail);
}

TT_EXPORT int tt_pca_project(const void* basis, const void* xc, const void* mean, void* proj, void* recon, int E,
                             int D, void* stream_) {
  if (E <= 0 || D < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int smem_max = 160 * 1024;  // of the H100's 227 KB a block may opt into
  const int tile = (smem_max / 16 - 8) / 8 * 8;
  const int smem = 2 * 2 * 4 * (tile + 8);
  const int vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(basis) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(xc) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(pca_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  pca_proj_kernel<<<E, PROJ_THREADS, smem, stream>>>(static_cast<const float*>(basis), static_cast<const float*>(xc),
                                                      static_cast<float*>(proj), E, D, tile, vec);
  if (D > 0)
    pca_recon_kernel<<<tt_blocks(D, 256), 256, 0, stream>>>(static_cast<const float*>(basis),
                                                             static_cast<const float*>(proj),
                                                             static_cast<const float*>(mean),
                                                             static_cast<float*>(recon), E, D);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// syevd_small: LAPACK's ssyevd('V', 'L') for n <= 64 as jaxlib runs it
// (ops/eigh.py's module note has the orders): slansy's scaling test and
// slascl; ssytrd (n <= 32: ssytd2; above: one slatrd panel of 32 columns
// with OpenBLAS's sgemv 'N' and 'T', ssymv, sdot, then ssyr2k on the trailing
// rows and ssytd2 on them); sstedc (ssteqr up to 25 rows; above, the split,
// the scaling, slaed0's pieces by ssteqr and their merges level by level:
// slaed2's deflation with OpenBLAS's fused srot, slaed4 / slaed5 / slaed6
// for each root, the Gu-Eisenstat vectors, sgemm as one FMA chain a value,
// then the selection sort); sormtr (sorm2r, or at n = 64 sormqr's blocks
// of 3 reflectors: the recursive slarft and slarfb).
//
// One block a matrix (EIG_THREADS threads). A, Z, the merge's two work
// matrices and slatrd's W live in dynamic shared memory (leading dimension
// EIG_LD); the sgemv 'T' forms in constant memory. Every output with an
// order of its own is one thread's: ssymv's rows (after its column dots),
// the rank-2 and ssyr2k updates, sgemv's rows or columns, the sgemm and
// slarfb values, the rotations of Z's rows, the secular roots, the
// Gu-Eisenstat products, slarf's columns. The scalar recurrences (slarfg,
// ssteqr's sweeps, slaed2's deflation, slamrg, the selection sort) run on
// thread 0 while the block waits at a barrier; ssteqr and slaed2 record
// their rotations, and the block applies them a row a thread. Every scalar
// is rounded where LAPACK's or OpenBLAS's code rounds it: __fmaf_rn exactly
// where OpenBLAS's kernels fuse, -fmad=false everywhere else. It runs once
// a video, at t == historySize.
//
// Replaces no TPU kernel: the JAX package calls jnp.linalg.eigh
// (tracking_tpu/bgs/eigenbackground.py:71), one LAPACK custom call.

#define EIG_N 64        // the largest n: one slatrd panel, two levels of slaed0 cuts
#define EIG_LD 65       // leading dimension of the shared matrices: odd, so a thread a column is free of bank conflicts
#define EIG_NB 32       // ssytrd's block size and crossover (ilaenv)
#define EIG_SMLSIZ 25   // LAPACK's SMLSIZ: above it sstedc divides and conquers
#define EIG_THREADS 256  // threads a block, a block a matrix (64 and 128 were slower on the H100: PERF.md)
#define EIG_SAFMIN 0x1p-126f
#define EIG_OPS 7168    // the sgemv 'T' programs (ops/eigh.py: _program_table)

__constant__ int eig_ops[EIG_OPS];
__constant__ int eig_offs[3 * EIG_N + 1];

struct EigShared {
  float A[EIG_N * EIG_LD], Z[EIG_N * EIG_LD], Q2[EIG_N * EIG_LD], S[EIG_N * EIG_LD], W[EIG_LD * EIG_NB];
  float d[EIG_N], e[EIG_N], tau[EIG_N], z[EIG_N], dlamda[EIG_N], w[EIG_N], v[EIG_N], t[EIG_N], nrm[EIG_N];
  float rc[EIG_N], rs[EIG_N], T[9];
  int rj[EIG_N], rp[EIG_N];
  int indxq[EIG_N], indx[EIG_N], indxc[EIG_N], indxp[EIG_N], coltyp[EIG_N], perm[EIG_N], sizes[8];
  int blk[2 * EIG_N];
  int nrot, more, k, ctot[4], lastv, lastc, info, nblk, flag;
  float fa, fb;
};

#define EIG_TID ((int)threadIdx.x)
#define EIG_NTH ((int)blockDim.x)

__device__ __forceinline__ float eig_sqrt(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ float eig_div(float a, float b) { return __fdiv_rn(a, b); }

__device__ float eig_slapy2(float x, float y) {
  if (isnan(x)) return x;
  if (isnan(y)) return y;
  const float xa = fabsf(x), ya = fabsf(y), w = fmaxf(xa, ya), z = fminf(xa, ya);
  if (z == 0.0f || w > 3.40282347e38f) return w;
  const float q = eig_div(z, w);
  return w * eig_sqrt(1.0f + q * q);
}

__device__ float eig_snrm2(const float* x, int n) {
  double acc = 0.0;
  for (int k = 0; k < n; ++k) acc = acc + (double)x[k] * (double)x[k];
  return (float)__dsqrt_rn(acc);
}

// slascl('G') of x[0..n) from cfrom to cto (in place)
__device__ void eig_slascl(float cfrom, float cto, float* x, int n, int stride) {
  const float small = EIG_SAFMIN, big = eig_div(1.0f, EIG_SAFMIN);
  float cf = cfrom, ct = cto;
  for (int it = 0; it < 64; ++it) {
    const float cf1 = cf * small;
    float mul;
    bool done;
    if (cf1 == cf) {
      mul = eig_div(ct, cf);
      done = true;
    } else {
      const float ct1 = eig_div(ct, big);
      if (ct1 == ct) {
        mul = ct;
        done = true;
        cf = 1.0f;
      } else if (fabsf(cf1) > fabsf(ct) && ct != 0.0f) {
        mul = small;
        done = false;
        cf = cf1;
      } else if (fabsf(ct1) > fabsf(cf)) {
        mul = big;
        done = false;
        ct = ct1;
      } else {
        mul = eig_div(ct, cf);
        done = true;
        if (mul == 1.0f) return;
      }
    }
    for (int k = 0; k < n; ++k) x[k * stride] = x[k * stride] * mul;
    if (done) return;
  }
}

__device__ void eig_slartg(float f, float g, float* c, float* s, float* r) {
  const float rtmin = 0x1p-63f;
  const float rtmax = 0x1.6a09e6p+62f;  // f32 sqrt(2^125)
  const float f1 = fabsf(f), g1 = fabsf(g);
  if (g == 0.0f) {
    *c = 1.0f;
    *s = 0.0f;
    *r = f;
  } else if (f == 0.0f) {
    *c = 0.0f;
    *s = copysignf(1.0f, g);
    *r = g1;
  } else if (f1 > rtmin && f1 < rtmax && g1 > rtmin && g1 < rtmax) {
    const float d = eig_sqrt(f * f + g * g);
    *c = eig_div(f1, d);
    *r = copysignf(d, f);
    *s = eig_div(g, *r);
  } else {
    const float u = fminf(0x1p126f, fmaxf(EIG_SAFMIN, fmaxf(f1, g1)));  // safmax = 2^126
    const float fs = eig_div(f, u), gs = eig_div(g, u);
    const float d = eig_sqrt(fs * fs + gs * gs);
    *c = eig_div(fabsf(fs), d);
    const float rr = copysignf(d, f);
    *s = eig_div(gs, rr);
    *r = rr * u;
  }
}

__device__ void eig_slaev2(float a, float b, float c, float* rt1, float* rt2, float* cs1, float* sn1) {
  const float sm = a + c, df = a - c, adf = fabsf(df), tb = b + b, ab = fabsf(tb);
  float acmx, acmn;
  if (fabsf(a) > fabsf(c)) {
    acmx = a;
    acmn = c;
  } else {
    acmx = c;
    acmn = a;
  }
  float rt;
  if (adf > ab) {
    const float q = eig_div(ab, adf);
    rt = adf * eig_sqrt(1.0f + q * q);
  } else if (adf < ab) {
    const float q = eig_div(adf, ab);
    rt = ab * eig_sqrt(1.0f + q * q);
  } else {
    rt = ab * 0x1.6a09e6p+0f;  // f32 sqrt(2)
  }
  int sgn1, sgn2;
  if (sm < 0.0f) {
    *rt1 = 0.5f * (sm - rt);
    sgn1 = -1;
    *rt2 = eig_div(acmx, *rt1) * acmn - eig_div(b, *rt1) * b;
  } else if (sm > 0.0f) {
    *rt1 = 0.5f * (sm + rt);
    sgn1 = 1;
    *rt2 = eig_div(acmx, *rt1) * acmn - eig_div(b, *rt1) * b;
  } else {
    *rt1 = 0.5f * rt;
    *rt2 = -0.5f * rt;
    sgn1 = 1;
  }
  float cs;
  if (df >= 0.0f) {
    cs = df + rt;
    sgn2 = 1;
  } else {
    cs = df - rt;
    sgn2 = -1;
  }
  float c1, s1;
  if (fabsf(cs) > ab) {
    const float ct = eig_div(-tb, cs);
    s1 = eig_div(1.0f, eig_sqrt(1.0f + ct * ct));
    c1 = ct * s1;
  } else if (ab == 0.0f) {
    c1 = 1.0f;
    s1 = 0.0f;
  } else {
    const float tn = eig_div(-cs, tb);
    c1 = eig_div(1.0f, eig_sqrt(1.0f + tn * tn));
    s1 = tn * c1;
  }
  if (sgn1 == sgn2) {
    const float tn = c1;
    c1 = -s1;
    s1 = tn;
  }
  *cs1 = c1;
  *sn1 = s1;
}

__device__ float eig_slanst(const float* d, const float* e, int n) {
  float an = fabsf(d[n - 1]);
  for (int i = 0; i < n - 1; ++i) {
    float s = fabsf(d[i]);
    if (an < s || isnan(s)) an = s;
    s = fabsf(e[i]);
    if (an < s || isnan(s)) an = s;
  }
  return an;
}

// ---- the divide and conquer's scalar routines (a thread each)

// slamrg: the 0-based order merging a[0, n1) ascending with a[n1, n1 + n2)
// read forwards (s2 = 1) or backwards (s2 = -1); ties take the first run
__device__ void eig_slamrg(int n1, int n2, const float* a, int s2, int* index) {
  int i1 = 0, i2 = s2 > 0 ? n1 : n1 + n2 - 1, r1 = n1, r2 = n2, i = 0;
  while (r1 > 0 && r2 > 0) {
    if (a[i1] <= a[i2]) {
      index[i++] = i1++;
      --r1;
    } else {
      index[i++] = i2;
      i2 += s2;
      --r2;
    }
  }
  for (; r2 > 0; --r2, i2 += s2) index[i++] = i2;
  for (; r1 > 0; --r1) index[i++] = i1++;
}

// slaed5: the i-th (1 or 2) eigenpair of the 2 x 2 secular problem
__device__ void eig_slaed5(int i, const float* d, const float* z, float* delta, float rho, float* dlam) {
  const float del = d[1] - d[0];
  float tau, b, c;
  if (i == 1) {
    const float w = 1.0f + eig_div(2.0f * rho * (z[1] * z[1] - z[0] * z[0]), del);
    if (w > 0.0f) {
      b = del + rho * (z[0] * z[0] + z[1] * z[1]);
      c = rho * z[0] * z[0] * del;
      tau = eig_div(2.0f * c, b + eig_sqrt(fabsf(b * b - 4.0f * c)));
      *dlam = d[0] + tau;
      delta[0] = eig_div(-z[0], tau);
      delta[1] = eig_div(z[1], del - tau);
    } else {
      b = -del + rho * (z[0] * z[0] + z[1] * z[1]);
      c = rho * z[1] * z[1] * del;
      if (b > 0.0f)
        tau = -eig_div(2.0f * c, b + eig_sqrt(b * b + 4.0f * c));
      else
        tau = (b - eig_sqrt(b * b + 4.0f * c)) / 2.0f;
      *dlam = d[1] + tau;
      delta[0] = eig_div(-z[0], del + tau);
      delta[1] = eig_div(-z[1], tau);
    }
  } else {
    b = -del + rho * (z[0] * z[0] + z[1] * z[1]);
    c = rho * z[1] * z[1] * del;
    if (b > 0.0f)
      tau = (b + eig_sqrt(b * b + 4.0f * c)) / 2.0f;
    else
      tau = eig_div(2.0f * c, -b + eig_sqrt(b * b + 4.0f * c));
    *dlam = d[1] + tau;
    delta[0] = eig_div(-z[0], del + tau);
    delta[1] = eig_div(-z[1], tau);
  }
  const float temp = eig_sqrt(delta[0] * delta[0] + delta[1] * delta[1]);
  delta[0] = eig_div(delta[0], temp);
  delta[1] = eig_div(delta[1], temp);
}

// LAPACK's root of its interpolating quadratic (slaed4 and slaed6)
__device__ __forceinline__ float eig_quad(float a, float b, float c, float at_c0) {
  if (c == 0.0f) return at_c0;
  const float root = eig_sqrt(fabsf(a * a - 4.0f * b * c));
  return a <= 0.0f ? eig_div(a - root, 2.0f * c) : eig_div(2.0f * b, a + root);
}

// slaed6: the root near the origin of rho + sum z_i / (d_i - x), i = 0..2
__device__ int eig_slaed6(int kniter, bool orgati, float rho, const float* d, const float* z, float finit,
                          float* tau_out) {
  float lbd = orgati ? d[1] : d[0], ubd = orgati ? d[2] : d[1];
  if (finit < 0.0f)
    lbd = 0.0f;
  else
    ubd = 0.0f;
  float tau = 0.0f, a, b, c, temp;
  if (kniter == 2) {
    if (orgati) {
      temp = (d[2] - d[1]) / 2.0f;
      c = rho + eig_div(z[0], (d[0] - d[1]) - temp);
      a = c * (d[1] + d[2]) + z[1] + z[2];
      b = c * d[1] * d[2] + z[1] * d[2] + z[2] * d[1];
    } else {
      temp = (d[0] - d[1]) / 2.0f;
      c = rho + eig_div(z[2], (d[2] - d[1]) - temp);
      a = c * (d[0] + d[1]) + z[0] + z[1];
      b = c * d[0] * d[1] + z[0] * d[1] + z[1] * d[0];
    }
    temp = fmaxf(fmaxf(fabsf(a), fabsf(b)), fabsf(c));
    a = eig_div(a, temp);
    b = eig_div(b, temp);
    c = eig_div(c, temp);
    tau = eig_quad(a, b, c, c == 0.0f ? eig_div(b, a) : 0.0f);
    if (tau < lbd || tau > ubd) tau = (lbd + ubd) / 2.0f;
    if (d[0] == tau || d[1] == tau || d[2] == tau) {
      tau = 0.0f;
    } else {
      temp = finit + eig_div(tau * z[0], d[0] * (d[0] - tau)) + eig_div(tau * z[1], d[1] * (d[1] - tau)) +
             eig_div(tau * z[2], d[2] * (d[2] - tau));
      if (temp <= 0.0f)
        lbd = tau;
      else
        ubd = tau;
      if (fabsf(finit) <= fabsf(temp)) tau = 0.0f;
    }
  }
  const float eps = 0x1p-24f, small1 = 0x1p-42f, small2 = small1 * small1;
  temp = orgati ? fminf(fabsf(d[1] - tau), fabsf(d[2] - tau)) : fminf(fabsf(d[0] - tau), fabsf(d[1] - tau));
  float ds[3], zs[3], sclinv = 1.0f;
  const bool scale = temp <= small1;
  const float sclfac = temp <= small2 ? 0x1p84f : 0x1p42f;
  if (scale) sclinv = temp <= small2 ? small2 : small1;
  for (int i = 0; i < 3; ++i) {
    ds[i] = scale ? d[i] * sclfac : d[i];
    zs[i] = scale ? z[i] * sclfac : z[i];
  }
  if (scale) {
    tau = tau * sclfac;
    lbd = lbd * sclfac;
    ubd = ubd * sclfac;
  }
  float fc = 0.0f, df = 0.0f, ddf = 0.0f;
  for (int i = 0; i < 3; ++i) {
    const float t = eig_div(1.0f, ds[i] - tau), t1 = zs[i] * t, t2 = t1 * t;
    fc = fc + eig_div(t1, ds[i]);
    df = df + t2;
    ddf = ddf + t2 * t;
  }
  float f = finit + tau * fc;
  int info = 0;
  if (!(fabsf(f) <= 0.0f)) {
    if (f <= 0.0f)
      lbd = tau;
    else
      ubd = tau;
    info = 1;
    for (int niter = 2; niter <= 40; ++niter) {
      const float t1 = orgati ? ds[1] - tau : ds[0] - tau, t2 = orgati ? ds[2] - tau : ds[1] - tau;
      a = (t1 + t2) * f - t1 * t2 * df;
      b = t1 * t2 * f;
      c = f - (t1 + t2) * df + t1 * t2 * ddf;
      temp = fmaxf(fmaxf(fabsf(a), fabsf(b)), fabsf(c));
      a = eig_div(a, temp);
      b = eig_div(b, temp);
      c = eig_div(c, temp);
      float eta = eig_quad(a, b, c, c == 0.0f ? eig_div(b, a) : 0.0f);
      if (f * eta >= 0.0f) eta = eig_div(-f, df);
      tau = tau + eta;
      if (tau < lbd || tau > ubd) tau = (lbd + ubd) / 2.0f;
      fc = 0.0f;
      float erretm = 0.0f;
      df = 0.0f;
      ddf = 0.0f;
      bool pole = false;
      for (int i = 0; i < 3; ++i) {
        if (ds[i] - tau != 0.0f) {
          const float t = eig_div(1.0f, ds[i] - tau), u1 = zs[i] * t, u2 = u1 * t, u4 = eig_div(u1, ds[i]);
          fc = fc + u4;
          erretm = erretm + fabsf(u4);
          df = df + u2;
          ddf = ddf + u2 * t;
        } else {
          pole = true;
          break;
        }
      }
      if (pole) {
        info = 0;
        break;
      }
      f = finit + tau * fc;
      erretm = 8.0f * (fabsf(finit) + fabsf(tau) * erretm) + fabsf(tau) * df;
      if (fabsf(f) <= 4.0f * eps * erretm || ubd - lbd <= 4.0f * eps * fabsf(tau)) {
        info = 0;
        break;
      }
      if (f <= 0.0f)
        lbd = tau;
      else
        ubd = tau;
    }
  }
  *tau_out = scale ? tau * sclinv : tau;
  return info;
}

// slaed4 (n >= 3): the i-th (1-based) root of 1/rho + sum z_j^2 / (d_j - x); delta_j = d_j - root
__device__ int eig_slaed4(int n, int i, const float* d, const float* z, float* delta, float rho, float* dlam) {
#define D(j) d[(j) - 1]
#define Z(j) z[(j) - 1]
#define DL(j) delta[(j) - 1]
  const float eps = 0x1p-24f, rhoinv = eig_div(1.0f, rho);
  float psi, dpsi, phi, dphi, erretm, w, c, a, b, tau, eta, temp, dltlb, dltub;
  if (i == n) {
    const int ii = n - 1;
    const float midpt = rho / 2.0f;
    for (int j = 1; j <= n; ++j) DL(j) = (D(j) - D(i)) - midpt;
    psi = 0.0f;
    for (int j = 1; j <= n - 2; ++j) psi = psi + eig_div(Z(j) * Z(j), DL(j));
    c = rhoinv + psi;
    w = c + eig_div(Z(ii) * Z(ii), DL(ii)) + eig_div(Z(n) * Z(n), DL(n));
    const float del = D(n) - D(n - 1);
    a = -c * del + Z(n - 1) * Z(n - 1) + Z(n) * Z(n);
    b = Z(n) * Z(n) * del;
    const float tq = a < 0.0f ? eig_div(2.0f * b, eig_sqrt(a * a + 4.0f * b * c) - a)
                              : eig_div(a + eig_sqrt(a * a + 4.0f * b * c), 2.0f * c);
    if (w <= 0.0f) {
      temp = eig_div(Z(n - 1) * Z(n - 1), D(n) - D(n - 1) + rho) + eig_div(Z(n) * Z(n), rho);
      tau = c <= temp ? rho : tq;
      dltlb = midpt;
      dltub = rho;
    } else {
      tau = tq;
      dltlb = 0.0f;
      dltub = midpt;
    }
    for (int j = 1; j <= n; ++j) DL(j) = (D(j) - D(i)) - tau;
    for (int niter = 1;; ++niter) {
      dpsi = 0.0f;
      psi = 0.0f;
      erretm = 0.0f;
      for (int j = 1; j <= ii; ++j) {
        temp = eig_div(Z(j), DL(j));
        psi = psi + Z(j) * temp;
        dpsi = dpsi + temp * temp;
        erretm = erretm + psi;
      }
      erretm = fabsf(erretm);
      temp = eig_div(Z(n), DL(n));
      phi = Z(n) * temp;
      dphi = temp * temp;
      erretm = 8.0f * (-phi - psi) + erretm - phi + rhoinv + fabsf(tau) * (dpsi + dphi);
      w = rhoinv + phi + psi;
      if (niter == 30) {  // MAXIT steps taken
        *dlam = D(i) + tau;
        return 1;
      }
      if (fabsf(w) <= eps * erretm) {
        *dlam = D(i) + tau;
        return 0;
      }
      if (w <= 0.0f)
        dltlb = fmaxf(dltlb, tau);
      else
        dltub = fminf(dltub, tau);
      c = w - DL(n - 1) * dpsi - DL(n) * dphi;
      a = (DL(n - 1) + DL(n)) * w - DL(n - 1) * DL(n) * (dpsi + dphi);
      b = DL(n - 1) * DL(n) * w;
      if (niter == 1 && c < 0.0f) c = fabsf(c);
      const float root = eig_sqrt(fabsf(a * a - 4.0f * b * c));
      if (niter == 1 && c == 0.0f)
        eta = eig_div(-w, dpsi + dphi);
      else if (a >= 0.0f)
        eta = eig_div(a + root, 2.0f * c);
      else
        eta = eig_div(2.0f * b, a - root);
      if (w * eta > 0.0f) eta = eig_div(-w, dpsi + dphi);
      temp = tau + eta;
      if (temp > dltub || temp < dltlb) eta = w < 0.0f ? (dltub - tau) / 2.0f : (dltlb - tau) / 2.0f;
      for (int j = 1; j <= n; ++j) DL(j) = DL(j) - eta;
      tau = tau + eta;
    }
  }
  // i < n
  const int ip1 = i + 1;
  const float del = D(ip1) - D(i), midpt = del / 2.0f;
  for (int j = 1; j <= n; ++j) DL(j) = (D(j) - D(i)) - midpt;
  psi = 0.0f;
  for (int j = 1; j <= i - 1; ++j) psi = psi + eig_div(Z(j) * Z(j), DL(j));
  phi = 0.0f;
  for (int j = n; j >= i + 2; --j) phi = phi + eig_div(Z(j) * Z(j), DL(j));
  c = rhoinv + psi + phi;
  w = c + eig_div(Z(i) * Z(i), DL(i)) + eig_div(Z(ip1) * Z(ip1), DL(ip1));
  const bool orgati = w > 0.0f;
  if (orgati) {
    a = c * del + Z(i) * Z(i) + Z(ip1) * Z(ip1);
    b = Z(i) * Z(i) * del;
    const float root = eig_sqrt(fabsf(a * a - 4.0f * b * c));
    tau = a > 0.0f ? eig_div(2.0f * b, a + root) : eig_div(a - root, 2.0f * c);
    dltlb = 0.0f;
    dltub = midpt;
  } else {
    a = c * del - Z(i) * Z(i) - Z(ip1) * Z(ip1);
    b = Z(ip1) * Z(ip1) * del;
    const float root = eig_sqrt(fabsf(a * a + 4.0f * b * c));
    tau = a < 0.0f ? eig_div(2.0f * b, a - root) : eig_div(-(a + root), 2.0f * c);
    dltlb = -midpt;
    dltub = 0.0f;
  }
  const float origin = orgati ? D(i) : D(ip1);
  for (int j = 1; j <= n; ++j) DL(j) = (D(j) - origin) - tau;
  const int ii = orgati ? i : i + 1, iim1 = ii - 1, iip1 = ii + 1;
  bool swtch3 = false, swtch = false;
  float dw, prew = 0.0f;
  int info = 0;
  for (int niter = 1;; ++niter) {
    dpsi = 0.0f;
    psi = 0.0f;
    erretm = 0.0f;
    for (int j = 1; j <= iim1; ++j) {
      temp = eig_div(Z(j), DL(j));
      psi = psi + Z(j) * temp;
      dpsi = dpsi + temp * temp;
      erretm = erretm + psi;
    }
    erretm = fabsf(erretm);
    dphi = 0.0f;
    phi = 0.0f;
    for (int j = n; j >= iip1; --j) {
      temp = eig_div(Z(j), DL(j));
      phi = phi + Z(j) * temp;
      dphi = dphi + temp * temp;
      erretm = erretm + phi;
    }
    w = rhoinv + phi + psi;
    if (niter == 1) swtch3 = (orgati ? w < 0.0f : w > 0.0f) && ii != 1 && ii != n;
    temp = eig_div(Z(ii), DL(ii));
    dw = dpsi + dphi + temp * temp;
    temp = Z(ii) * temp;
    w = w + temp;
    erretm = 8.0f * (phi - psi) + erretm + 2.0f * rhoinv + 3.0f * fabsf(temp) + fabsf(tau) * dw;
    if (niter == 2) {
      swtch = orgati ? -w > eig_div(fabsf(prew), 10.0f) : w > eig_div(fabsf(prew), 10.0f);
    } else if (niter > 2 && w * prew > 0.0f && fabsf(w) > eig_div(fabsf(prew), 10.0f)) {
      swtch = !swtch;
    }
    if (niter == 30) {
      info = 1;
      break;
    }
    if (fabsf(w) <= eps * erretm) break;
    if (w <= 0.0f)
      dltlb = fmaxf(dltlb, tau);
    else
      dltub = fminf(dltub, tau);
    if (!swtch3) {
      const float dlo = DL(i), dhi = DL(ip1);
      if (!swtch) {
        if (orgati) {
          const float t = eig_div(Z(i), dlo);
          c = w - dhi * dw - (D(i) - D(ip1)) * (t * t);
        } else {
          const float t = eig_div(Z(ip1), dhi);
          c = w - dlo * dw - (D(ip1) - D(i)) * (t * t);
        }
      } else {
        temp = eig_div(Z(ii), DL(ii));
        if (orgati)
          dpsi = dpsi + temp * temp;
        else
          dphi = dphi + temp * temp;
        c = w - dlo * dpsi - dhi * dphi;
      }
      a = (dlo + dhi) * w - dlo * dhi * dw;
      b = dlo * dhi * w;
      if (c == 0.0f && a == 0.0f) {
        if (!swtch)
          a = orgati ? Z(i) * Z(i) + dhi * dhi * (dpsi + dphi) : Z(ip1) * Z(ip1) + dlo * dlo * (dpsi + dphi);
        else
          a = dlo * dlo * dpsi + dhi * dhi * dphi;
      }
      eta = eig_quad(a, b, c, c == 0.0f ? eig_div(b, a) : 0.0f);
    } else {
      temp = rhoinv + psi + phi;
      float zz[3];
      const float dm = DL(iim1), dp = DL(iip1);
      if (swtch) {
        c = temp - dm * dpsi - dp * dphi;
        zz[0] = dm * dm * dpsi;
        zz[2] = dp * dp * dphi;
      } else if (orgati) {
        float t1 = eig_div(Z(iim1), dm);
        t1 = t1 * t1;
        c = temp - dp * (dpsi + dphi) - (D(iim1) - D(iip1)) * t1;
        zz[0] = Z(iim1) * Z(iim1);
        zz[2] = dp * dp * ((dpsi - t1) + dphi);
      } else {
        float t1 = eig_div(Z(iip1), dp);
        t1 = t1 * t1;
        c = temp - dm * (dpsi + dphi) - (D(iip1) - D(iim1)) * t1;
        zz[0] = dm * dm * (dpsi + (dphi - t1));
        zz[2] = Z(iip1) * Z(iip1);
      }
      zz[1] = Z(ii) * Z(ii);
      info = eig_slaed6(niter + 1, orgati, c, &DL(iim1), zz, w, &eta);
      if (info != 0) break;
    }
    if (w * eta >= 0.0f) eta = eig_div(-w, dw);
    temp = tau + eta;
    if (temp > dltub || temp < dltlb) eta = w < 0.0f ? (dltub - tau) / 2.0f : (dltlb - tau) / 2.0f;
    for (int j = 1; j <= n; ++j) DL(j) = DL(j) - eta;
    tau = tau + eta;
    prew = w;
  }
  *dlam = origin + tau;
  return info;
#undef D
#undef Z
#undef DL
}
// ---- the block's pieces (every thread calls them; each ends at a barrier)

// OpenBLAS's sgemv 'T' of one column a[0..m) with v by a postfix program;
// kind 0, 1, 2: the column's kernel takes 4, 2 or 1 columns at once
__device__ float eig_form(int kind, int m, const float* a, const float* v) {
  float st[8];
  int top = 0;
  const int end = eig_offs[kind * EIG_N + m + 1];
  for (int q = eig_offs[kind * EIG_N + m]; q < end; ++q) {
    const int op = eig_ops[q] >> 6, r = eig_ops[q] & 63;
    if (op == 0) {
      st[top++] = a[r] * v[r];
    } else if (op == 1) {
      st[top - 1] = __fmaf_rn(a[r], v[r], st[top - 1]);
    } else if (op == 2) {
      st[top - 1] = st[top - 1] + a[r] * v[r];
    } else {
      st[top - 2] = st[top - 2] + st[top - 1];
      --top;
    }
  }
  return st[0];
}

// the sgemv 'T' kernel of column j of ncols: groups of 4, a pair, one
__device__ __forceinline__ int eig_kind(int j, int ncols) {
  const int n4 = ncols - ncols % 4;
  return j < n4 ? 0 : ((ncols % 4 & 2) && j < n4 + 2 ? 1 : 2);
}

// OpenBLAS's sgemv 'N' (alpha -1, beta 1) for row r of m: y - A[r, :k] x,
// one FMA chain over the columns; at k = 4 the first 4 floor((m mod 16) / 4)
// rows sum (p0 fused with p2) + (p1 fused with p3)
__device__ float eig_gemv_n(const float* A, int r, int k, const float* x, int xs, float y, int m) {
  if (k == 0) return y;
  float acc;
  if (k == 4 && r < (m % 16) / 4 * 4) {
    acc = __fmaf_rn(A[r + 2 * EIG_LD], x[2 * xs], A[r] * x[0]) +
          __fmaf_rn(A[r + 3 * EIG_LD], x[3 * xs], A[r + EIG_LD] * x[xs]);
  } else {
    acc = 0.0f;
    for (int j = 0; j < k; ++j) acc = __fmaf_rn(A[r + j * EIG_LD], x[j * xs], acc);
  }
  return y - acc;
}

// ssymv lower, beta 0, in OpenBLAS's order: y = alpha S x over k rows. The
// column dots t2 first (a thread a column: the block's triangle, then 4
// lanes where at least 12 rows lie below the block, the rest in a chain),
// then each row's chain over its columns in order (a thread a row)
__device__ void eig_symv(float alpha, const float* S, const float* x, float* y, float* t2, int k) {
  const int o1 = k / 4 * 4;
  for (int c = EIG_TID; c < k; c += EIG_NTH) {
    float acc = 0.0f;
    int rest = c + 1;
    if (c < o1) {
      const int j = c / 4 * 4;
      for (int i = c + 1; i < j + 4; ++i) acc = __fmaf_rn(S[i + c * EIG_LD], x[i], acc);
      rest = j + 4;
      if (k - (j + 1) >= 12 && o1 > j + 4) {
        float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int r = j + 4; r < o1; r += 4)
          for (int q = 0; q < 4; ++q) l[q] = __fmaf_rn(S[(r + q) + c * EIG_LD], x[r + q], l[q]);
        acc = acc + ((l[0] + l[1]) + (l[2] + l[3]));
        rest = o1;
      }
    }
    for (int i = rest; i < k; ++i) acc = __fmaf_rn(S[i + c * EIG_LD], x[i], acc);
    t2[c] = acc;
  }
  __syncthreads();
  for (int i = EIG_TID; i < k; i += EIG_NTH) {
    float acc = 0.0f;
    for (int j = 0; j < o1 && j <= i; j += 4) {
      if (i >= j + 4) {
        for (int c = 0; c < 4; ++c) acc = __fmaf_rn(alpha * x[j + c], S[i + (j + c) * EIG_LD], acc);
      } else {
        acc = __fmaf_rn(alpha * x[i], S[i + i * EIG_LD], acc);
        for (int c = j; c < i; ++c) acc = __fmaf_rn(alpha * x[c], S[i + c * EIG_LD], acc);
        acc = __fmaf_rn(alpha, t2[i], acc);
      }
    }
    if (i >= o1) {
      for (int j = o1; j < i; ++j) acc = __fmaf_rn(alpha * x[j], S[i + j * EIG_LD], acc);
      acc = __fmaf_rn(alpha * x[i], S[i + i * EIG_LD], acc);
      acc = __fmaf_rn(alpha, t2[i], acc);
    }
    y[i] = acc;
  }
  __syncthreads();
}

// OpenBLAS's sdot: the first 32 products (n >= 32) in 8 f32 lanes added
// ((0+4) + (1+5)) + ((2+6) + (3+7)), the other products added in f64
__device__ float eig_sdot(const float* x, const float* y, int n) {
  double acc = 0.0;
  int k0 = 0;
  if (n >= 32) {
    float s[8];
    for (int l = 0; l < 8; ++l) s[l] = ((x[l] * y[l] + x[l + 8] * y[l + 8]) + x[l + 16] * y[l + 16]) + x[l + 24] * y[l + 24];
    float h[4];
    for (int l = 0; l < 4; ++l) h[l] = s[l] + s[l + 4];
    acc = (double)((h[0] + h[1]) + (h[2] + h[3]));
    k0 = 32;
  }
  for (int k = k0; k < n; ++k) acc = acc + (double)(x[k] * y[k]);
  return (float)acc;
}

// slarfg (thread 0): alpha in *beta_io, x[k] -> beta, tau, v (in x)
__device__ void eig_slarfg(float* beta_io, float* x, int k, float* tau_out) {
  float alpha = *beta_io, beta = alpha, taui = 0.0f;
  if (k > 0) {
    const float xnorm = eig_snrm2(x, k);
    if (xnorm != 0.0f) {
      beta = -copysignf(eig_slapy2(alpha, xnorm), alpha);
      const float safmin = 0x1p-102f, rsafmn = 0x1p102f;  // slamch('S') / slamch('E') and its inverse
      int knt = 0;
      if (fabsf(beta) < safmin) {
        do {
          ++knt;
          for (int q = 0; q < k; ++q) x[q] = x[q] * rsafmn;
          beta = beta * rsafmn;
          alpha = alpha * rsafmn;
        } while (fabsf(beta) < safmin && knt < 20);
        beta = -copysignf(eig_slapy2(alpha, eig_snrm2(x, k)), alpha);
      }
      taui = eig_div(beta - alpha, beta);
      const float sc = eig_div(1.0f, alpha - beta);
      for (int q = 0; q < k; ++q) x[q] = x[q] * sc;
      for (int q = 0; q < knt; ++q) beta = beta * safmin;
    }
  }
  *beta_io = beta;
  *tau_out = taui;
}

// ssytd2, lower, on the m x m block of A at (off, off): d, e, tau at off
__device__ void eig_ssytd2(EigShared& sh, int off, int m) {
  float* A = sh.A + off * (1 + EIG_LD);
  for (int i = 0; i < m - 1; ++i) {
    if (EIG_TID == 0) {
      float beta = A[(i + 1) + i * EIG_LD], taui;
      eig_slarfg(&beta, &A[(i + 2) + i * EIG_LD], m - i - 2, &taui);
      sh.e[off + i] = beta;
      sh.tau[off + i] = taui;
      A[(i + 1) + i * EIG_LD] = 1.0f;
    }
    __syncthreads();
    const float taui = sh.tau[off + i];
    const int mm = m - i - 1;
    const float* vv = &A[(i + 1) + i * EIG_LD];
    float* S = &A[(i + 1) + (i + 1) * EIG_LD];
    if (taui != 0.0f) {
      eig_symv(taui, S, vv, sh.w, sh.t, mm);
      if (EIG_TID == 0) sh.fb = (-0.5f * taui) * eig_sdot(sh.w, vv, mm);
      __syncthreads();
      const float alph = sh.fb;
      for (int q = EIG_TID; q < mm; q += EIG_NTH) sh.w[q] = __fmaf_rn(alph, vv[q], sh.w[q]);
      __syncthreads();
      for (int idx = EIG_TID; idx < mm * mm; idx += EIG_NTH) {  // ssyr2: a thread an element
        const int r = idx % mm, c = idx / mm;
        if (r >= c) S[r + c * EIG_LD] = __fmaf_rn(-sh.w[c], vv[r], __fmaf_rn(-vv[c], sh.w[r], S[r + c * EIG_LD]));
      }
      __syncthreads();
    }
    if (EIG_TID == 0) {
      A[(i + 1) + i * EIG_LD] = sh.e[off + i];
      sh.d[off + i] = A[i + i * EIG_LD];
    }
    __syncthreads();
  }
  if (EIG_TID == 0) sh.d[off + m - 1] = A[(m - 1) + (m - 1) * EIG_LD];
  __syncthreads();
}

// ssytrd, lower: ssytd2 up to NB rows; above, slatrd on the first NB
// columns (W in shared memory), ssyr2k on the trailing rows, ssytd2 on them
__device__ void eig_ssytrd(EigShared& sh, int n) {
  if (n <= EIG_NB) {
    eig_ssytd2(sh, 0, n);
    return;
  }
  float* A = sh.A;
  float* W = sh.W;
  for (int i = 0; i < EIG_NB; ++i) {
    if (i > 0) {  // A(i:, i) -= A(i:, :i) W(i, :i)^T + W(i:, :i) A(i, :i)^T
      const int m = n - i;
      for (int r = EIG_TID; r < m; r += EIG_NTH) {
        float y = A[(i + r) + i * EIG_LD];
        y = eig_gemv_n(A + i, r, i, W + i, EIG_LD, y, m);
        y = eig_gemv_n(W + i, r, i, A + i, EIG_LD, y, m);
        A[(i + r) + i * EIG_LD] = y;
      }
      __syncthreads();
    }
    if (EIG_TID == 0) {
      float beta = A[(i + 1) + i * EIG_LD], taui;
      eig_slarfg(&beta, &A[(i + 2) + i * EIG_LD], n - i - 2, &taui);
      sh.e[i] = beta;
      sh.tau[i] = taui;
      A[(i + 1) + i * EIG_LD] = 1.0f;
    }
    __syncthreads();
    const int mm = n - i - 1;
    const float taui = sh.tau[i];
    const float* vv = &A[(i + 1) + i * EIG_LD];
    float* wc = &W[(i + 1) + i * EIG_LD];
    eig_symv(1.0f, &A[(i + 1) + (i + 1) * EIG_LD], vv, wc, sh.t, mm);
    if (i > 0) {
      for (int c = EIG_TID; c < i; c += EIG_NTH) sh.v[c] = eig_form(eig_kind(c, i), mm, &W[(i + 1) + c * EIG_LD], vv);
      __syncthreads();
      for (int r = EIG_TID; r < mm; r += EIG_NTH) wc[r] = eig_gemv_n(A + i + 1, r, i, sh.v, 1, wc[r], mm);
      __syncthreads();
      for (int c = EIG_TID; c < i; c += EIG_NTH) sh.v[c] = eig_form(eig_kind(c, i), mm, &A[(i + 1) + c * EIG_LD], vv);
      __syncthreads();
      for (int r = EIG_TID; r < mm; r += EIG_NTH) wc[r] = eig_gemv_n(W + i + 1, r, i, sh.v, 1, wc[r], mm);
      __syncthreads();
    }
    for (int r = EIG_TID; r < mm; r += EIG_NTH) wc[r] = taui == 0.0f ? 0.0f : wc[r] * taui;  // sscal
    __syncthreads();
    if (EIG_TID == 0) sh.fb = (-0.5f * taui) * eig_sdot(wc, vv, mm);
    __syncthreads();
    const float alph = sh.fb;
    if (alph != 0.0f)  // saxpy returns at once on a zero alpha
      for (int r = EIG_TID; r < mm; r += EIG_NTH) wc[r] = __fmaf_rn(alph, vv[r], wc[r]);
    __syncthreads();
  }
  const int m2 = n - EIG_NB;  // ssyr2k: C += (-A2 W2^T) + (-W2 A2^T), each an FMA chain over the NB terms
  for (int idx = EIG_TID; idx < m2 * m2; idx += EIG_NTH) {
    const int r = idx % m2, c = idx / m2;
    if (r < c) continue;
    float a1 = 0.0f, a2 = 0.0f;
    for (int q = 0; q < EIG_NB; ++q) {
      a1 = __fmaf_rn(A[(EIG_NB + r) + q * EIG_LD], W[(EIG_NB + c) + q * EIG_LD], a1);
      a2 = __fmaf_rn(A[(EIG_NB + c) + q * EIG_LD], W[(EIG_NB + r) + q * EIG_LD], a2);
    }
    float* C = &A[(EIG_NB + r) + (EIG_NB + c) * EIG_LD];
    *C = *C + ((-a1) + (-a2));
  }
  __syncthreads();
  if (EIG_TID == 0)
    for (int j = 0; j < EIG_NB; ++j) {
      A[(j + 1) + j * EIG_LD] = sh.e[j];
      sh.d[j] = A[j + j * EIG_LD];
    }
  __syncthreads();
  eig_ssytd2(sh, EIG_NB, n - EIG_NB);
}

// ---- ssteqr: thread 0 steps through the routine, the block rotates Z's rows

struct EigSteqr {
  int l1, l, lend, lsv, lendsv, jtot, iscale, phase;  // phase 0 split, 1 QL, 2 QR, 5 unscale, 3 done, 4 failed
  float anorm;
};

// thread 0: ssteqr's scalar steps up to its next batch of rotations
// (sh.nrot: a 2 x 2 block's or a sweep's, in slasr's order) or its end
__device__ void eig_steqr_step(EigSteqr& s, float* d, float* e, int n, EigShared& sh) {
  const float eps = 0x1p-24f, eps2 = eps * eps;
  const float ssfmax = eig_div(0x1p63f, 3.0f);  // sqrt(2^126) / 3
  const float ssfmin = 0x1p-15f;                // sqrt(2^-126) / eps^2
  const int nmaxit = 30 * n;
  sh.nrot = 0;
#define D(i) d[(i) - 1]
#define E(i) e[(i) - 1]
  while (true) {
    if (s.phase == 0) {
      if (s.l1 > n) {
        s.phase = 3;
        return;
      }
      if (s.l1 > 1) E(s.l1 - 1) = 0.0f;
      int m = n;
      for (int mm = s.l1; mm <= n - 1; ++mm) {
        const float tst = fabsf(E(mm));
        if (tst == 0.0f) {
          m = mm;
          break;
        }
        if (tst <= (eig_sqrt(fabsf(D(mm))) * eig_sqrt(fabsf(D(mm + 1)))) * eps) {
          E(mm) = 0.0f;
          m = mm;
          break;
        }
      }
      s.l = s.l1;
      s.lsv = s.l;
      s.lend = m;
      s.lendsv = m;
      s.l1 = m + 1;
      if (s.lend == s.l) continue;
      s.anorm = eig_slanst(&D(s.l), &E(s.l), s.lend - s.l + 1);
      s.iscale = 0;
      if (s.anorm == 0.0f) continue;
      if (s.anorm > ssfmax) {
        s.iscale = 1;
        eig_slascl(s.anorm, ssfmax, &D(s.l), s.lend - s.l + 1, 1);
        eig_slascl(s.anorm, ssfmax, &E(s.l), s.lend - s.l, 1);
      } else if (s.anorm < ssfmin) {
        s.iscale = 2;
        eig_slascl(s.anorm, ssfmin, &D(s.l), s.lend - s.l + 1, 1);
        eig_slascl(s.anorm, ssfmin, &E(s.l), s.lend - s.l, 1);
      }
      if (fabsf(D(s.lend)) < fabsf(D(s.l))) {
        s.lend = s.lsv;
        s.l = s.lendsv;
      }
      s.phase = s.lend > s.l ? 1 : 2;
    }
    if (s.phase == 1) {  // QL: one event
      const int l = s.l, lend = s.lend;
      int m = lend;
      if (l != lend)
        for (int mm = l; mm <= lend - 1; ++mm) {
          const float tst = fabsf(E(mm)) * fabsf(E(mm));
          if (tst <= (eps2 * fabsf(D(mm))) * fabsf(D(mm + 1)) + EIG_SAFMIN) {
            m = mm;
            break;
          }
        }
      if (m < lend) E(m) = 0.0f;
      float p = D(l);
      if (m == l) {
        s.l = l + 1;
        if (s.l > lend) s.phase = 5;
        continue;
      }
      if (m == l + 1) {
        float rt1, rt2, c, sn;
        eig_slaev2(D(l), E(l), D(l + 1), &rt1, &rt2, &c, &sn);
        sh.rj[0] = l;
        sh.rc[0] = c;
        sh.rs[0] = sn;
        sh.nrot = 1;
        D(l) = rt1;
        D(l + 1) = rt2;
        E(l) = 0.0f;
        s.l = l + 2;
        if (s.l > lend) s.phase = 5;
        return;
      }
      if (s.jtot == nmaxit) {
        s.phase = 5;
        continue;
      }
      s.jtot += 1;
      float g = eig_div(D(l + 1) - p, 2.0f * E(l));
      float r = eig_slapy2(g, 1.0f);
      g = (D(m) - p) + eig_div(E(l), g + copysignf(r, g));
      float sn = 1.0f, c = 1.0f;
      p = 0.0f;
      int q = 0;
      for (int i = m - 1; i >= l; --i) {
        const float f = sn * E(i), b = c * E(i);
        eig_slartg(g, f, &c, &sn, &r);
        if (i != m - 1) E(i + 1) = r;
        g = D(i + 1) - p;
        r = (D(i) - g) * sn + (2.0f * c) * b;
        p = sn * r;
        D(i + 1) = g + p;
        g = c * r - b;
        sh.rj[q] = i;
        sh.rc[q] = c;
        sh.rs[q] = -sn;
        ++q;
      }
      sh.nrot = q;
      D(l) = D(l) - p;
      E(l) = g;
      return;
    }
    if (s.phase == 2) {  // QR: one event
      const int l = s.l, lend = s.lend;
      int m = lend;
      if (l != lend)
        for (int mm = l; mm >= lend + 1; --mm) {
          const float tst = fabsf(E(mm - 1)) * fabsf(E(mm - 1));
          if (tst <= (eps2 * fabsf(D(mm))) * fabsf(D(mm - 1)) + EIG_SAFMIN) {
            m = mm;
            break;
          }
        }
      if (m > lend) E(m - 1) = 0.0f;
      float p = D(l);
      if (m == l) {
        s.l = l - 1;
        if (s.l < lend) s.phase = 5;
        continue;
      }
      if (m == l - 1) {
        float rt1, rt2, c, sn;
        eig_slaev2(D(l - 1), E(l - 1), D(l), &rt1, &rt2, &c, &sn);
        sh.rj[0] = l - 1;
        sh.rc[0] = c;
        sh.rs[0] = sn;
        sh.nrot = 1;
        D(l - 1) = rt1;
        D(l) = rt2;
        E(l - 1) = 0.0f;
        s.l = l - 2;
        if (s.l < lend) s.phase = 5;
        return;
      }
      if (s.jtot == nmaxit) {
        s.phase = 5;
        continue;
      }
      s.jtot += 1;
      float g = eig_div(D(l - 1) - p, 2.0f * E(l - 1));
      float r = eig_slapy2(g, 1.0f);
      g = (D(m) - p) + eig_div(E(l - 1), g + copysignf(r, g));
      float sn = 1.0f, c = 1.0f;
      p = 0.0f;
      int q = 0;
      for (int i = m; i <= l - 1; ++i) {
        const float f = sn * E(i), b = c * E(i);
        eig_slartg(g, f, &c, &sn, &r);
        if (i != m) E(i - 1) = r;
        g = D(i) - p;
        r = (D(i + 1) - g) * sn + (2.0f * c) * b;
        p = sn * r;
        D(i) = g + p;
        g = c * r - b;
        sh.rj[q] = i;
        sh.rc[q] = c;
        sh.rs[q] = sn;
        ++q;
      }
      sh.nrot = q;
      D(l) = D(l) - p;
      E(l - 1) = g;
      return;
    }
    if (s.phase == 5) {  // undo the block's scaling
      if (s.iscale == 1) {
        eig_slascl(ssfmax, s.anorm, &D(s.lsv), s.lendsv - s.lsv + 1, 1);
        eig_slascl(ssfmax, s.anorm, &E(s.lsv), s.lendsv - s.lsv, 1);
      } else if (s.iscale == 2) {
        eig_slascl(ssfmin, s.anorm, &D(s.lsv), s.lendsv - s.lsv + 1, 1);
        eig_slascl(ssfmin, s.anorm, &E(s.lsv), s.lendsv - s.lsv, 1);
      }
      if (s.jtot >= nmaxit) {
        int info = 0;
        for (int i = 1; i <= n - 1; ++i)
          if (E(i) != 0.0f) ++info;
        sh.info = info;
        s.phase = 4;
        return;
      }
      s.phase = 0;
      continue;
    }
    return;
  }
#undef D
#undef E
}

// the columns of Z (n rows) in the order perm (through Q2)
__device__ void eig_permute_cols(float* Z, int n, EigShared& sh) {
  for (int idx = EIG_TID; idx < n * n; idx += EIG_NTH) {
    const int r = idx % n, j = idx / n;
    sh.Q2[r + j * EIG_LD] = Z[r + sh.perm[j] * EIG_LD];
  }
  __syncthreads();
  for (int idx = EIG_TID; idx < n * n; idx += EIG_NTH) {
    const int r = idx % n, j = idx / n;
    Z[r + j * EIG_LD] = sh.Q2[r + j * EIG_LD];
  }
  __syncthreads();
}

// LAPACK's selection sort of d[n] and Z's columns (thread 0 finds the order)
__device__ void eig_selection_sort(float* d, float* Z, int n, EigShared& sh) {
  if (EIG_TID == 0) {
    for (int j = 0; j < n; ++j) sh.perm[j] = j;
    for (int i = 0; i < n - 1; ++i) {
      int k = i;
      float p = d[i];
      for (int j = i + 1; j < n; ++j)
        if (d[j] < p) {
          k = j;
          p = d[j];
        }
      if (k != i) {
        d[k] = d[i];
        d[i] = p;
        const int t = sh.perm[i];
        sh.perm[i] = sh.perm[k];
        sh.perm[k] = t;
      }
    }
  }
  __syncthreads();
  eig_permute_cols(Z, n, sh);
}

// ssteqr, COMPZ = 'I': d[n], e[n - 1], Z (leading dimension EIG_LD); returns info
__device__ int eig_ssteqr(float* d, float* e, float* Z, int n, EigShared& sh) {
  for (int idx = EIG_TID; idx < n * n; idx += EIG_NTH) {
    const int i = idx % n, j = idx / n;
    Z[i + j * EIG_LD] = i == j ? 1.0f : 0.0f;
  }
  if (EIG_TID == 0) sh.info = 0;
  __syncthreads();
  if (n <= 1) return 0;
  EigSteqr s;
  s.l1 = 1;
  s.jtot = 0;
  s.phase = 0;
  while (true) {
    if (EIG_TID == 0) {
      eig_steqr_step(s, d, e, n, sh);
      sh.more = s.phase == 1 || s.phase == 2 || s.phase == 5 || s.phase == 0;
    }
    __syncthreads();
    const int nrot = sh.nrot;
    for (int r = EIG_TID; r < n; r += EIG_NTH)
      for (int q = 0; q < nrot; ++q) {  // slasr: plane (j, j + 1) (1-based)
        const float ct = sh.rc[q], st = sh.rs[q];
        if (ct == 1.0f && st == 0.0f) continue;
        float* a = &Z[r + (sh.rj[q] - 1) * EIG_LD];
        float* b = &Z[r + sh.rj[q] * EIG_LD];
        const float temp = *b;
        *b = ct * temp - st * *a;
        *a = st * temp + ct * *a;
      }
    const int more = sh.more;
    __syncthreads();
    if (!more) break;
  }
  const int info = sh.info;
  __syncthreads();
  if (info != 0) return info;
  eig_selection_sort(d, Z, n, sh);
  return 0;
}

// ---- sstedc's divide and conquer

// The merge of two adjacent pieces (slaed1 -> slaed2 -> slaed3), in place:
// d[n] holds the pieces' eigenvalues (each ascending in the order indxq
// gives, 0-based in its piece), Q (leading dimension EIG_LD) their
// eigenvectors block-diagonally, rho the cut's off-diagonal; indxq[n] gets
// the ascending order of the merged eigenvalues. Thread 0 deflates
// (recording slaed2's rotations); the block rotates Q's rows, solves the
// secular equation a root a thread and forms the vectors a value a thread.
__device__ int eig_slaed1(float* d, float* Q, int* indxq, float rho, int n, int n1, EigShared& sh) {
  if (EIG_TID == 0) {
    const int n2 = n - n1;
    float* z = sh.z;
    for (int j = 0; j < n1; ++j) z[j] = Q[(n1 - 1) + j * EIG_LD];
    for (int j = n1; j < n; ++j) z[j] = Q[n1 + j * EIG_LD];
    if (rho < 0.0f)
      for (int j = n1; j < n; ++j) z[j] = z[j] * -1.0f;
    const float t = 0x1.6a09e6p-1f;  // ONE / SQRT(TWO) in f32
    for (int j = 0; j < n; ++j) z[j] = z[j] * t;
    rho = fabsf(2.0f * rho);
    for (int j = n1; j < n; ++j) indxq[j] += n1;
    for (int j = 0; j < n; ++j) sh.dlamda[j] = d[indxq[j]];
    eig_slamrg(n1, n2, sh.dlamda, 1, sh.indxc);
    for (int j = 0; j < n; ++j) sh.indx[j] = indxq[sh.indxc[j]];
    int imax = 0, jmax = 0;
    for (int j = 1; j < n; ++j) {
      if (fabsf(z[j]) > fabsf(z[imax])) imax = j;
      if (fabsf(d[j]) > fabsf(d[jmax])) jmax = j;
    }
    const float tol = 8.0f * 0x1p-24f * fmaxf(fabsf(d[jmax]), fabsf(z[imax]));
    sh.nrot = 0;
    sh.info = 0;
    sh.fa = rho;
    if (rho * fabsf(z[imax]) <= tol) {  // nothing to merge: the columns in d's order
      sh.flag = 1;
      sh.k = 0;
      for (int j = 0; j < n; ++j) sh.w[j] = d[sh.indx[j]];
    } else {
      sh.flag = 0;
      int* coltyp = sh.coltyp;
      int* indxp = sh.indxp;
      for (int j = 0; j < n; ++j) coltyp[j] = j < n1 ? 1 : 3;
      int k = 0, k2 = n, pj = -1, nrot = 0;
      for (int j = 0; j < n; ++j) {
        const int nj = sh.indx[j];
        if (rho * fabsf(z[nj]) <= tol) {  // a negligible z component
          coltyp[nj] = 4;
          indxp[--k2] = nj;
          continue;
        }
        if (pj < 0) {
          pj = nj;
          continue;
        }
        float s = z[pj], c = z[nj];
        const float tau = eig_slapy2(c, s), tt = d[nj] - d[pj];
        c = eig_div(c, tau);
        s = eig_div(-s, tau);
        if (fabsf(tt * c * s) <= tol) {  // two close eigenvalues: a rotation zeroes z(pj)
          z[nj] = tau;
          z[pj] = 0.0f;
          if (coltyp[nj] != coltyp[pj]) coltyp[nj] = 2;
          coltyp[pj] = 4;
          sh.rp[nrot] = pj;
          sh.rj[nrot] = nj;
          sh.rc[nrot] = c;
          sh.rs[nrot] = s;
          ++nrot;
          const float dp = d[pj], dn = d[nj];
          const float tp = dp * (c * c) + dn * (s * s);
          d[nj] = dp * (s * s) + dn * (c * c);
          d[pj] = tp;
          int at = --k2;
          while (at + 1 < n && d[pj] < d[indxp[at + 1]]) {
            indxp[at] = indxp[at + 1];
            ++at;
          }
          indxp[at] = pj;
        } else {
          sh.dlamda[k] = d[pj];
          sh.w[k] = z[pj];
          indxp[k++] = pj;
        }
        pj = nj;
      }
      sh.dlamda[k] = d[pj];
      sh.w[k] = z[pj];
      indxp[k++] = pj;
      // group the columns: 1 (top piece only), 2 (both), 3 (bottom only), 4 (deflated)
      int psm[4];
      for (int q = 0; q < 4; ++q) sh.ctot[q] = 0;
      for (int j = 0; j < n; ++j) ++sh.ctot[coltyp[j] - 1];
      psm[0] = 0;
      for (int q = 1; q < 4; ++q) psm[q] = psm[q - 1] + sh.ctot[q - 1];
      for (int j = 0; j < n; ++j) {
        const int js = indxp[j], ct = coltyp[js] - 1;
        sh.indx[psm[ct]] = js;
        sh.indxc[psm[ct]++] = j;
      }
      sh.nrot = nrot;
      sh.k = k;
    }
  }
  __syncthreads();
  if (sh.flag) {
    for (int idx = EIG_TID; idx < n * n; idx += EIG_NTH) {
      const int r = idx % n, j = idx / n;
      sh.Q2[r + j * EIG_LD] = Q[r + sh.indx[j] * EIG_LD];
    }
    __syncthreads();
    for (int idx = EIG_TID; idx < n * n; idx += EIG_NTH) {
      const int r = idx % n, j = idx / n;
      Q[r + j * EIG_LD] = sh.Q2[r + j * EIG_LD];
    }
    for (int j = EIG_TID; j < n; j += EIG_NTH) {
      d[j] = sh.w[j];
      indxq[j] = j;
    }
    __syncthreads();
    return 0;
  }
  const int nrot = sh.nrot, k = sh.k;
  const float rho2 = sh.fa;
  for (int r = EIG_TID; r < n; r += EIG_NTH)  // slaed2's rotations (OpenBLAS's srot), a row a thread
    for (int q = 0; q < nrot; ++q) {
      const float c = sh.rc[q], s = sh.rs[q];
      const float x = Q[r + sh.rp[q] * EIG_LD], y = Q[r + sh.rj[q] * EIG_LD];
      Q[r + sh.rp[q] * EIG_LD] = __fmaf_rn(c, x, s * y);
      Q[r + sh.rj[q] * EIG_LD] = __fmaf_rn(c, y, -(s * x));
    }
  __syncthreads();
  for (int idx = EIG_TID; idx < n * n; idx += EIG_NTH) {  // Q2: the grouped columns, whole
    const int r = idx % n, j = idx / n;
    sh.Q2[r + j * EIG_LD] = Q[r + sh.indx[j] * EIG_LD];
  }
  for (int j = EIG_TID; j < n; j += EIG_NTH) sh.z[j] = d[sh.indx[j]];
  __syncthreads();
  for (int idx = EIG_TID; idx < n * (n - k); idx += EIG_NTH) {  // the deflated ones from k on
    const int r = idx % n, j = k + idx / n;
    Q[r + j * EIG_LD] = sh.Q2[r + j * EIG_LD];
  }
  for (int j = k + EIG_TID; j < n; j += EIG_NTH) d[j] = sh.z[j];
  // slaed3: a root a thread (slaed4, slaed5 for k = 2), delta in S's column
  for (int j = EIG_TID; j < k; j += EIG_NTH) {
    float* col = sh.S + j * EIG_LD;
    if (k == 1) {
      d[0] = sh.dlamda[0] + rho2 * sh.w[0] * sh.w[0];
      col[0] = 1.0f;
    } else if (k == 2) {
      eig_slaed5(j + 1, sh.dlamda, sh.w, col, rho2, &d[j]);
    } else {
      const int inf = eig_slaed4(k, j + 1, sh.dlamda, sh.w, col, rho2, &d[j]);
      if (inf != 0) atomicMax(&sh.info, inf);
    }
  }
  __syncthreads();
  const int info = sh.info;
  if (info != 0) return info;
  if (k >= 3) {  // Gu and Eisenstat's vector: a value a thread, then each column's norm
    for (int q = EIG_TID; q < k; q += EIG_NTH) {
      float wv = sh.S[q + q * EIG_LD];
      for (int j = 0; j < k; ++j)
        if (j != q) wv = wv * eig_div(sh.S[q + j * EIG_LD], sh.dlamda[q] - sh.dlamda[j]);
      sh.t[q] = copysignf(eig_sqrt(-wv), sh.w[q]);
    }
    __syncthreads();
    for (int j = EIG_TID; j < k; j += EIG_NTH) {
      float* col = sh.S + j * EIG_LD;
      for (int q = 0; q < k; ++q) col[q] = eig_div(sh.t[q], col[q]);
      sh.nrm[j] = eig_snrm2(col, k);
    }
    __syncthreads();
  }
  // sgemm, one FMA chain a value: the top rows from the columns of types 1, 2, the bottom from types 2, 3
  const int c0 = sh.ctot[0], n12 = sh.ctot[0] + sh.ctot[1], n23 = sh.ctot[1] + sh.ctot[2];
  for (int idx = EIG_TID; idx < n * k; idx += EIG_NTH) {
    const int r = idx % n, j = idx / n;
    const float* col = sh.S + j * EIG_LD;
    const int q0 = r < n1 ? 0 : c0, nq = r < n1 ? n12 : n23;
    float acc = 0.0f;
    for (int q = q0; q < q0 + nq; ++q) {
      const float g = k >= 3 ? eig_div(col[sh.indxc[q]], sh.nrm[j]) : col[sh.indxc[q]];
      acc = __fmaf_rn(sh.Q2[r + q * EIG_LD], g, acc);
    }
    Q[r + j * EIG_LD] = acc;
  }
  __syncthreads();
  if (EIG_TID == 0) eig_slamrg(k, n - k, d, -1, indxq);
  __syncthreads();
  return 0;
}

// sstedc, COMPZ = 'I' on sh.d, sh.e -> sh.Z: ssteqr up to SMLSIZ; above, the
// split where |e_f| <= eps sqrt|d_f| sqrt|d_f+1|, each block above SMLSIZ
// scaled to norm 1 and cut into slaed0's pieces (halved until at most
// SMLSIZ rows), the pieces by ssteqr, merged pairwise level by level, put in
// ascending order and scaled back; the other blocks by ssteqr; then the
// selection sort. Returns info.
__device__ int eig_sstedc(EigShared& sh, int n) {
  float* d = sh.d;
  float* e = sh.e;
  float* Z = sh.Z;
  if (n <= EIG_SMLSIZ) return eig_ssteqr(d, e, Z, n, sh);
  for (int idx = EIG_TID; idx < n * n; idx += EIG_NTH) {
    const int i = idx % n, j = idx / n;
    Z[i + j * EIG_LD] = i == j ? 1.0f : 0.0f;
  }
  if (EIG_TID == 0) {
    sh.flag = eig_slanst(d, e, n) == 0.0f;
    const float eps = 0x1p-24f;
    int nb = 0;
    for (int start = 0; start < n;) {
      int finish = start;
      while (finish < n - 1 && fabsf(e[finish]) > eps * eig_sqrt(fabsf(d[finish])) * eig_sqrt(fabsf(d[finish + 1])))
        ++finish;
      sh.blk[2 * nb] = start;
      sh.blk[2 * nb + 1] = finish;
      ++nb;
      start = finish + 1;
    }
    sh.nblk = nb;
  }
  __syncthreads();
  if (sh.flag) return 0;
  const int nblk = sh.nblk;
  for (int b = 0; b < nblk; ++b) {
    const int start = sh.blk[2 * b], finish = sh.blk[2 * b + 1], m = finish - start + 1;
    const int code = (start + 1) * (n + 1) + finish + 1;
    float* Zb = Z + start * (1 + EIG_LD);
    if (m > EIG_SMLSIZ) {
      if (EIG_TID == 0) {
        float* db = d + start;
        float* eb = e + start;
        const float nrm = eig_slanst(db, eb, m);
        sh.fb = nrm;
        eig_slascl(nrm, 1.0f, db, m, 1);
        eig_slascl(nrm, 1.0f, eb, m - 1, 1);
        int ns = 1;
        sh.sizes[0] = m;
        while (sh.sizes[ns - 1] > EIG_SMLSIZ) {
          for (int j = ns - 1; j >= 0; --j) {
            const int sz = sh.sizes[j];
            sh.sizes[2 * j + 1] = (sz + 1) / 2;
            sh.sizes[2 * j] = sz / 2;
          }
          ns *= 2;
        }
        sh.lastv = ns;
        int at = 0;
        for (int j = 0; j < ns - 1; ++j) {  // the cuts
          at += sh.sizes[j];
          const float r = fabsf(eb[at - 1]);
          db[at - 1] = db[at - 1] - r;
          db[at] = db[at] - r;
        }
      }
      __syncthreads();
      int cnt = sh.lastv, sizes[8];
      for (int j = 0; j < cnt; ++j) sizes[j] = sh.sizes[j];
      int at = start;
      for (int j = 0; j < cnt; ++j) {
        if (eig_ssteqr(d + at, e + at, Z + at * (1 + EIG_LD), sizes[j], sh) != 0) return code;
        for (int q = EIG_TID; q < sizes[j]; q += EIG_NTH) sh.indxq[at + q] = q;
        at += sizes[j];
      }
      __syncthreads();
      while (cnt > 1) {
        at = start;
        for (int j = 0; j < cnt; j += 2) {
          const int mm = sizes[j] + sizes[j + 1], n1 = sizes[j];
          if (eig_slaed1(d + at, Z + at * (1 + EIG_LD), sh.indxq + at, e[at + n1 - 1], mm, n1, sh) != 0) return code;
          at += mm;
        }
        for (int j = 0; j < cnt / 2; ++j) sizes[j] = sizes[2 * j] + sizes[2 * j + 1];
        cnt /= 2;
      }
      if (EIG_TID == 0) {  // the block in its ascending order, the scale undone
        for (int j = 0; j < m; ++j) {
          sh.perm[j] = sh.indxq[start + j];
          sh.t[j] = d[start + sh.perm[j]];
        }
        for (int j = 0; j < m; ++j) d[start + j] = sh.t[j];
        eig_slascl(1.0f, sh.fb, d + start, m, 1);
      }
      __syncthreads();
      eig_permute_cols(Zb, m, sh);
    } else if (m > 1) {
      if (eig_ssteqr(d + start, e + start, Zb, m, sh) != 0) return code;
    }
  }
  eig_selection_sort(d, Z, n, sh);
  return 0;
}

// ---- sormtr

// OpenBLAS's sgemm('T', 'N') sum over q >= 1 terms of a[t] b[t]: below 32
// one FMA chain; from 32 16 lanes (term t in lane t mod 16), added pairwise
// for a row in a whole group of 4 rows, else by halves
__device__ float eig_tn_sum(const float* a, const float* b, int q, bool pairs) {
  if (q < 32) {
    float acc = a[0] * b[0];
    for (int t = 1; t < q; ++t) acc = __fmaf_rn(a[t], b[t], acc);
    return acc;
  }
  float l[16];
  for (int c = 0; c < 16; ++c) {
    l[c] = a[c] * b[c];
    for (int t = c + 16; t < q; t += 16) l[c] = __fmaf_rn(a[t], b[t], l[c]);
  }
  for (int w = 16; w > 1; w /= 2)
    for (int j = 0; j < w / 2; ++j) l[j] = pairs ? l[2 * j] + l[2 * j + 1] : l[j] + l[j + w / 2];
  return l[0];
}

// slarft('F', 'C') of 3 reflectors as OpenBLAS ships it (LAPACK's recursive
// version), thread 0: V (mv >= 3 rows, unit diagonal implied, leading
// dimension EIG_LD), tau[3] -> T (row-major 3 x 3, upper)
__device__ void eig_slarft3(const float* V, int mv, const float* tau, float* T) {
  const int q = mv - 3;
  // T22 of reflectors 1, 2: X = V(2, 1), plus V(3:, 1)^T V(3:, 2), times -tau1, times tau2
  float x = V[2 + EIG_LD] * 1.0f;
  if (q > 0) x = x + eig_tn_sum(V + 3 + EIG_LD, V + 3 + 2 * EIG_LD, q, false);
  x = -(tau[1] * x);
  x = x * tau[2];
  // T12: [V(1, 0), V(2, 0)] times V22 (unit lower), plus V(3:, 0)^T V(3:, 1:3), times -tau0, times T22
  float x0 = __fmaf_rn(V[2], V[2 + EIG_LD], V[1] * 1.0f), x1 = V[2] * 1.0f;
  if (q > 0) {
    x0 = x0 + eig_tn_sum(V + 3, V + 3 + EIG_LD, q, false);
    x1 = x1 + eig_tn_sum(V + 3, V + 3 + 2 * EIG_LD, q, false);
  }
  x0 = -(tau[0] * x0);
  x1 = -(tau[0] * x1);
  const float y0 = x0 * tau[1];
  const float y1 = __fmaf_rn(x1, tau[2], x0 * x);
  T[0] = tau[0];
  T[1] = y0;
  T[2] = y1;
  T[3] = 0.0f;
  T[4] = tau[1];
  T[5] = x;
  T[6] = 0.0f;
  T[7] = 0.0f;
  T[8] = tau[2];
}

// sormtr('L', 'L', 'N') of ssyevd on Z's rows 1..: sorm2r (slarf: sgemv 'T'
// a column a thread, then sger an element a thread), H(n - 2) first; at n =
// 64 ssyevd's workspace gives sormqr blocks of 3 reflectors from the last:
// slarft, then slarfb (strmm's and sgemm's values a column of C a thread)
__device__ void eig_sormtr(EigShared& sh, int n) {
  const float* A = sh.A;
  if (n < EIG_N) {
    for (int i = n - 2; i >= 0; --i) {
      const int m = n - 1 - i;
      float* C = sh.Z + 1 + i;
      for (int q = EIG_TID; q < m; q += EIG_NTH) sh.v[q] = q == 0 ? 1.0f : A[(i + 1 + q) + i * EIG_LD];
      __syncthreads();
      if (EIG_TID == 0) {
        int lastv = sh.tau[i] != 0.0f ? m : 0;
        while (lastv > 0 && sh.v[lastv - 1] == 0.0f) --lastv;
        sh.lastv = lastv;
        sh.lastc = 0;
      }
      __syncthreads();
      const int lastv = sh.lastv;
      if (lastv > 0) {
        for (int j = EIG_TID; j < n; j += EIG_NTH)
          for (int r = 0; r < lastv; ++r)
            if (C[r + j * EIG_LD] != 0.0f) {
              atomicMax(&sh.lastc, j + 1);
              break;
            }
        __syncthreads();
        const int lastc = sh.lastc;
        for (int j = EIG_TID; j < lastc; j += EIG_NTH) sh.t[j] = eig_form(eig_kind(j, lastc), lastv, C + j * EIG_LD, sh.v);
        __syncthreads();
        const float taui = sh.tau[i];
        for (int idx = EIG_TID; idx < lastv * lastc; idx += EIG_NTH) {
          const int r = idx % lastv, j = idx / lastv;
          C[r + j * EIG_LD] = __fmaf_rn(-taui * sh.t[j], sh.v[r], C[r + j * EIG_LD]);
        }
      }
      __syncthreads();
    }
    return;
  }
  for (int i0 = EIG_N - 4; i0 >= 0; i0 -= 3) {
    const int mv = EIG_N - 1 - i0, q = mv - 3;
    const float* V = A + (1 + i0) + i0 * EIG_LD;
    float* C = sh.Z + 1 + i0;
    if (EIG_TID == 0) eig_slarft3(V, mv, sh.tau + i0, sh.T);
    __syncthreads();
    const float* T = sh.T;
    for (int c = EIG_TID; c < EIG_N; c += EIG_NTH) {
      float* cc = C + c * EIG_LD;
      float w[3], w3[3];
      w[0] = __fmaf_rn(cc[2], V[2], __fmaf_rn(cc[1], V[1], cc[0] * 1.0f));  // C1^T V1
      w[1] = __fmaf_rn(cc[2], V[2 + EIG_LD], cc[1] * 1.0f);
      w[2] = cc[2] * 1.0f;
      if (q > 0)
        for (int j = 0; j < 3; ++j) w[j] = w[j] + eig_tn_sum(cc + 3, V + 3 + j * EIG_LD, q, true);  // + C2^T V2
      w3[0] = __fmaf_rn(w[2], T[2], __fmaf_rn(w[1], T[1], w[0] * T[0]));  // times T^T
      w3[1] = __fmaf_rn(w[2], T[5], w[1] * T[4]);
      w3[2] = w[2] * T[8];
      for (int j = 0; j < 3; ++j) sh.W[c + j * EIG_LD] = w3[j];
      const float w50 = w3[0] * 1.0f;  // times V1^T, then C1 -= W^T
      const float w51 = __fmaf_rn(w3[1], 1.0f, w3[0] * V[1]);
      const float w52 = __fmaf_rn(w3[2], 1.0f, __fmaf_rn(w3[1], V[2 + EIG_LD], w3[0] * V[2]));
      cc[0] = cc[0] - w50;
      cc[1] = cc[1] - w51;
      cc[2] = cc[2] - w52;
    }
    __syncthreads();
    for (int idx = EIG_TID; idx < q * EIG_N; idx += EIG_NTH) {  // C2 -= V2 W^T: an FMA chain over the 3 terms
      const int r = 3 + idx % q, c = idx / q;
      const float acc = __fmaf_rn(V[r + 2 * EIG_LD], sh.W[c + 2 * EIG_LD],
                                  __fmaf_rn(V[r + EIG_LD], sh.W[c + EIG_LD], V[r] * sh.W[c]));
      C[r + c * EIG_LD] = C[r + c * EIG_LD] - acc;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(EIG_THREADS) syevd_small_kernel(const float* __restrict__ G, float* __restrict__ W,
                                                                   float* __restrict__ V, int* __restrict__ info_out,
                                                                   int n) {
  extern __shared__ __align__(16) unsigned char eig_smem[];
  EigShared& sh = *reinterpret_cast<EigShared*>(eig_smem);
  const long long b = blockIdx.x;
  const float* g = G + b * n * n;
  for (int idx = EIG_TID; idx < n * n; idx += EIG_NTH) sh.A[idx / n + (idx % n) * EIG_LD] = g[idx];
  __syncthreads();
  if (n == 1) {
    if (EIG_TID == 0) {
      W[b] = sh.A[0];
      V[b] = 1.0f;
      info_out[b] = 0;
    }
    return;
  }
  if (EIG_TID == 0) {  // slansy('M', 'L') and the scaling of ssyevd
    float anrm = 0.0f;
    for (int j = 0; j < n; ++j)
      for (int i = j; i < n; ++i) {
        const float s = fabsf(sh.A[i + j * EIG_LD]);
        if (anrm < s || isnan(s)) anrm = s;
      }
    const float rmin = 0x1.6a09e6p-52f, rmax = 0x1.6a09e6p+51f;  // f32 sqrt(2^-103), sqrt(2^103)
    sh.flag = 0;
    sh.fa = 1.0f;
    if (anrm > 0.0f && anrm < rmin) {
      sh.flag = 1;
      sh.fa = eig_div(rmin, anrm);
    } else if (anrm > rmax) {
      sh.flag = 1;
      sh.fa = eig_div(rmax, anrm);
    }
  }
  __syncthreads();
  const bool scaled = sh.flag;
  const float sigma = sh.fa;
  __syncthreads();
  if (scaled) {
    for (int j = EIG_TID; j < n; j += EIG_NTH) eig_slascl(1.0f, sigma, &sh.A[j + j * EIG_LD], n - j, 1);
    __syncthreads();
  }
  eig_ssytrd(sh, n);
  const int info = eig_sstedc(sh, n);
  eig_sormtr(sh, n);
  if (EIG_TID == 0 && scaled) {
    const float rs = eig_div(1.0f, sigma);
    for (int q = 0; q < n; ++q) sh.d[q] = sh.d[q] * rs;
  }
  __syncthreads();
  for (int q = EIG_TID; q < n; q += EIG_NTH) W[b * n + q] = sh.d[q];
  for (int idx = EIG_TID; idx < n * n; idx += EIG_NTH) V[b * n * n + idx] = sh.Z[idx / n + (idx % n) * EIG_LD];
  if (EIG_TID == 0) info_out[b] = info;
}

TT_EXPORT int tt_syevd_small(const void* G, void* W, void* V, void* info, const void* ops, const void* offs, int B,
                             int n, int n_ops, void* stream_) {
  if (B < 0 || n < 1 || n > EIG_N || n_ops < 0 || n_ops > EIG_OPS) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err = cudaMemcpyToSymbolAsync(eig_ops, ops, n_ops * sizeof(int), 0, cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(eig_offs, offs, (3 * EIG_N + 1) * sizeof(int), 0, cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(syevd_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(EigShared));
  if (err != cudaSuccess) return (int)err;
  syevd_small_kernel<<<B, EIG_THREADS, sizeof(EigShared), stream>>>(
      static_cast<const float*>(G), static_cast<float*>(W), static_cast<float*>(V), static_cast<int*>(info), n);
  return (int)cudaGetLastError();
}
