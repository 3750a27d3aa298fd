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
// syevd_small: LAPACK's ssyevd('V', 'L') for n <= 32 as jaxlib runs it
// (ops/eigh.py's module note has the orders): slansy's scaling test and
// slascl, ssytd2 (slarfg with OpenBLAS's snrm2, ssymv, sdot, saxpy, ssyr2),
// sstedc (for n <= 25 ssteqr: QL / QR with slaev2, slartg, slapy2, slascl,
// selection sort; above, the split, the scaling, the two halves by ssteqr
// and their merge: slaed2's deflation with OpenBLAS's fused srot, slaed4 /
// slaed5 / slaed6 for each root, the Gu-Eisenstat vectors, sgemm as one FMA
// chain a value, then the selection sort) and sorm2r (sgemv 'T' by the
// postfix programs of ops/eigh.py's forms, sger).
// One thread a matrix, LAPACK's scalar order; __fmaf_rn exactly where
// OpenBLAS's kernels fuse, every other operation rounded on its own
// (-fmad=false). It runs once a video, at t == historySize.
//
// Replaces no TPU kernel: the JAX package calls jnp.linalg.eigh
// (tracking_tpu/bgs/eigenbackground.py:71), one LAPACK custom call.

#define EIG_N 32       // the largest n: ssytrd and sormtr stay unblocked
#define EIG_SMLSIZ 25  // LAPACK's SMLSIZ: above it sstedc divides and conquers
#define EIG_SAFMIN 0x1p-126f

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

// ssymv lower, beta 0, in OpenBLAS's order; S column-major with leading dimension ld
__device__ void eig_symv(float alpha, const float* S, int ld, const float* x, float* y, int k) {
  for (int i = 0; i < k; ++i) y[i] = 0.0f;
  const int o1 = k / 4 * 4;
  for (int j = 0; j < o1; j += 4) {
    float t1[4], t2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < 4; ++c) t1[c] = alpha * x[j + c];
    for (int c = 0; c < 4; ++c) y[j + c] = __fmaf_rn(t1[c], S[(j + c) + (j + c) * ld], y[j + c]);
    for (int c = 0; c < 3; ++c)
      for (int i = j + c + 1; i < j + 4; ++i) {
        y[i] = __fmaf_rn(t1[c], S[i + (j + c) * ld], y[i]);
        t2[c] = __fmaf_rn(S[i + (j + c) * ld], x[i], t2[c]);
      }
    int rest = j + 4;
    if (k - (j + 1) >= 12 && o1 > j + 4) {
      for (int i = j + 4; i < o1; ++i)
        for (int c = 0; c < 4; ++c) y[i] = __fmaf_rn(t1[c], S[i + (j + c) * ld], y[i]);
      for (int c = 0; c < 4; ++c) {
        float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int r = j + 4; r < o1; r += 4)
          for (int q = 0; q < 4; ++q) l[q] = __fmaf_rn(S[(r + q) + (j + c) * ld], x[r + q], l[q]);
        t2[c] = t2[c] + ((l[0] + l[1]) + (l[2] + l[3]));
      }
      rest = o1;
    }
    for (int i = rest; i < k; ++i)
      for (int c = 0; c < 4; ++c) {
        y[i] = __fmaf_rn(t1[c], S[i + (j + c) * ld], y[i]);
        t2[c] = __fmaf_rn(S[i + (j + c) * ld], x[i], t2[c]);
      }
    for (int c = 0; c < 4; ++c) y[j + c] = __fmaf_rn(alpha, t2[c], y[j + c]);
  }
  for (int j = o1; j < k; ++j) {
    const float t1 = alpha * x[j];
    float t2 = 0.0f;
    y[j] = __fmaf_rn(t1, S[j + j * ld], y[j]);
    for (int i = j + 1; i < k; ++i) {
      y[i] = __fmaf_rn(t1, S[i + j * ld], y[i]);
      t2 = __fmaf_rn(S[i + j * ld], x[i], t2);
    }
    y[j] = __fmaf_rn(alpha, t2, y[j]);
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

// slasr's plane (j, j + 1) (1-based columns) of Z (column-major, n rows, leading dimension ld)
__device__ __forceinline__ void eig_rot(float* Z, int n, int ld, int j, float ct, float st) {
  if (ct == 1.0f && st == 0.0f) return;
  float* a = Z + (j - 1) * ld;
  float* b = Z + j * ld;
  for (int i = 0; i < n; ++i) {
    const float temp = b[i];
    b[i] = ct * temp - st * a[i];
    a[i] = st * temp + ct * a[i];
  }
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

// ssteqr, COMPZ = 'I'; d[n], e[n - 1], Z column-major with leading dimension ld; returns info
__device__ int eig_ssteqr(float* d, float* e, float* Z, int n, int ld) {
  for (int j = 0; j < n; ++j)
    for (int i = 0; i < n; ++i) Z[i + j * ld] = i == j ? 1.0f : 0.0f;
  if (n <= 1) return 0;
  const float eps = 0x1p-24f, eps2 = eps * eps;
  const float ssfmax = eig_div(0x1p63f, 3.0f);  // sqrt(2^126) / 3
  const float ssfmin = 0x1p-15f;                // sqrt(2^-126) / eps^2
  const int nmaxit = 30 * n;
  int jtot = 0, l1 = 1;
#define D(i) d[(i) - 1]
#define E(i) e[(i) - 1]
  while (true) {
    if (l1 > n) break;
    if (l1 > 1) E(l1 - 1) = 0.0f;
    int m = n;
    for (int mm = l1; mm <= n - 1; ++mm) {
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
    int l = l1;
    const int lsv = l;
    int lend = m;
    const int lendsv = lend;
    l1 = m + 1;
    if (lend == l) continue;
    const float anorm = eig_slanst(&D(l), &E(l), lend - l + 1);
    int iscale = 0;
    if (anorm == 0.0f) continue;
    if (anorm > ssfmax) {
      iscale = 1;
      eig_slascl(anorm, ssfmax, &D(l), lend - l + 1, 1);
      eig_slascl(anorm, ssfmax, &E(l), lend - l, 1);
    } else if (anorm < ssfmin) {
      iscale = 2;
      eig_slascl(anorm, ssfmin, &D(l), lend - l + 1, 1);
      eig_slascl(anorm, ssfmin, &E(l), lend - l, 1);
    }
    if (fabsf(D(lend)) < fabsf(D(l))) {
      lend = lsv;
      l = lendsv;
    }
    if (lend > l) {  // QL
      while (true) {
        int mq = lend;
        if (l != lend)
          for (int mm = l; mm <= lend - 1; ++mm) {
            const float tst = fabsf(E(mm)) * fabsf(E(mm));
            if (tst <= (eps2 * fabsf(D(mm))) * fabsf(D(mm + 1)) + EIG_SAFMIN) {
              mq = mm;
              break;
            }
          }
        m = mq;
        if (m < lend) E(m) = 0.0f;
        float p = D(l);
        if (m == l) {
          D(l) = p;
          l = l + 1;
          if (l <= lend) continue;
          break;
        }
        if (m == l + 1) {
          float rt1, rt2, c, s;
          eig_slaev2(D(l), E(l), D(l + 1), &rt1, &rt2, &c, &s);
          eig_rot(Z, n, ld, l, c, s);
          D(l) = rt1;
          D(l + 1) = rt2;
          E(l) = 0.0f;
          l = l + 2;
          if (l <= lend) continue;
          break;
        }
        if (jtot == nmaxit) break;
        jtot = jtot + 1;
        float g = eig_div(D(l + 1) - p, 2.0f * E(l));
        float r = eig_slapy2(g, 1.0f);
        g = (D(m) - p) + eig_div(E(l), g + copysignf(r, g));
        float s = 1.0f, c = 1.0f;
        p = 0.0f;
        for (int i = m - 1; i >= l; --i) {
          const float f = s * E(i), b = c * E(i);
          eig_slartg(g, f, &c, &s, &r);
          if (i != m - 1) E(i + 1) = r;
          g = D(i + 1) - p;
          r = (D(i) - g) * s + (2.0f * c) * b;
          p = s * r;
          D(i + 1) = g + p;
          g = c * r - b;
          eig_rot(Z, n, ld, i, c, -s);
        }
        D(l) = D(l) - p;
        E(l) = g;
      }
    } else {  // QR
      while (true) {
        int mq = lend;
        if (l != lend)
          for (int mm = l; mm >= lend + 1; --mm) {
            const float tst = fabsf(E(mm - 1)) * fabsf(E(mm - 1));
            if (tst <= (eps2 * fabsf(D(mm))) * fabsf(D(mm - 1)) + EIG_SAFMIN) {
              mq = mm;
              break;
            }
          }
        m = mq;
        if (m > lend) E(m - 1) = 0.0f;
        float p = D(l);
        if (m == l) {
          D(l) = p;
          l = l - 1;
          if (l >= lend) continue;
          break;
        }
        if (m == l - 1) {
          float rt1, rt2, c, s;
          eig_slaev2(D(l - 1), E(l - 1), D(l), &rt1, &rt2, &c, &s);
          eig_rot(Z, n, ld, l - 1, c, s);
          D(l - 1) = rt1;
          D(l) = rt2;
          E(l - 1) = 0.0f;
          l = l - 2;
          if (l >= lend) continue;
          break;
        }
        if (jtot == nmaxit) break;
        jtot = jtot + 1;
        float g = eig_div(D(l - 1) - p, 2.0f * E(l - 1));
        float r = eig_slapy2(g, 1.0f);
        g = (D(m) - p) + eig_div(E(l - 1), g + copysignf(r, g));
        float s = 1.0f, c = 1.0f;
        p = 0.0f;
        for (int i = m; i <= l - 1; ++i) {
          const float f = s * E(i), b = c * E(i);
          eig_slartg(g, f, &c, &s, &r);
          if (i != m) E(i - 1) = r;
          g = D(i) - p;
          r = (D(i + 1) - g) * s + (2.0f * c) * b;
          p = s * r;
          D(i) = g + p;
          g = c * r - b;
          eig_rot(Z, n, ld, i, c, s);
        }
        D(l) = D(l) - p;
        E(l - 1) = g;
      }
    }
    if (iscale == 1) {
      eig_slascl(ssfmax, anorm, &D(lsv), lendsv - lsv + 1, 1);
      eig_slascl(ssfmax, anorm, &E(lsv), lendsv - lsv, 1);
    } else if (iscale == 2) {
      eig_slascl(ssfmin, anorm, &D(lsv), lendsv - lsv + 1, 1);
      eig_slascl(ssfmin, anorm, &E(lsv), lendsv - lsv, 1);
    }
    if (jtot >= nmaxit) {
      int info = 0;
      for (int i = 1; i <= n - 1; ++i)
        if (E(i) != 0.0f) ++info;
      return info;
    }
  }
  for (int ii = 2; ii <= n; ++ii) {  // selection sort
    const int i = ii - 1;
    int k = i;
    float p = D(i);
    for (int j = ii; j <= n; ++j)
      if (D(j) < p) {
        k = j;
        p = D(j);
      }
    if (k != i) {
      D(k) = D(i);
      D(i) = p;
      for (int r = 0; r < n; ++r) {
        const float t = Z[r + (i - 1) * ld];
        Z[r + (i - 1) * ld] = Z[r + (k - 1) * ld];
        Z[r + (k - 1) * ld] = t;
      }
    }
  }
#undef D
#undef E
  return 0;
}

// ---- sstedc's divide and conquer (n = 26-32: one cut, two halves by ssteqr)

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

// The merge of sstedc's two halves (slaed1 -> slaed2 -> slaed3), in place:
// d[n] holds the halves' eigenvalues (each ascending), Q (leading dimension
// ld) their eigenvectors block-diagonally, rho the cut's off-diagonal;
// indxq[n] gets the ascending order of the merged eigenvalues (0-based).
struct EigMerge {
  float z[EIG_N], dlamda[EIG_N], w[EIG_N], q2[EIG_N * EIG_N], s[EIG_N * EIG_N];
  int indx[EIG_N], indxc[EIG_N], indxp[EIG_N], coltyp[EIG_N];
};

__device__ int eig_slaed1(int n, float* d, float* Q, int ld, int* indxq, float rho, int n1, EigMerge& m) {
  const int n2 = n - n1;
  for (int j = 0; j < n1; ++j) m.z[j] = Q[(n1 - 1) + j * ld];
  for (int j = n1; j < n; ++j) m.z[j] = Q[n1 + j * ld];
  for (int j = 0; j < n; ++j) indxq[j] = j < n1 ? j : j - n1;
  // ---- slaed2: deflation
  if (rho < 0.0f)
    for (int j = n1; j < n; ++j) m.z[j] = m.z[j] * -1.0f;
  const float t = 0x1.6a09e6p-1f;  // ONE / SQRT(TWO) in f32
  for (int j = 0; j < n; ++j) m.z[j] = m.z[j] * t;
  rho = fabsf(2.0f * rho);
  for (int j = n1; j < n; ++j) indxq[j] += n1;
  for (int j = 0; j < n; ++j) m.dlamda[j] = d[indxq[j]];
  eig_slamrg(n1, n2, m.dlamda, 1, m.indxc);
  for (int j = 0; j < n; ++j) m.indx[j] = indxq[m.indxc[j]];
  int imax = 0, jmax = 0;
  for (int j = 1; j < n; ++j) {
    if (fabsf(m.z[j]) > fabsf(m.z[imax])) imax = j;
    if (fabsf(d[j]) > fabsf(d[jmax])) jmax = j;
  }
  const float tol = 8.0f * 0x1p-24f * fmaxf(fabsf(d[jmax]), fabsf(m.z[imax]));
  int k = 0;
  if (rho * fabsf(m.z[imax]) <= tol) {  // nothing to merge: the columns in d's order
    for (int j = 0; j < n; ++j) {
      const int c = m.indx[j];
      for (int r = 0; r < n; ++r) m.q2[r + j * n] = Q[r + c * ld];
      m.dlamda[j] = d[c];
    }
    for (int j = 0; j < n; ++j)
      for (int r = 0; r < n; ++r) Q[r + j * ld] = m.q2[r + j * n];
    for (int j = 0; j < n; ++j) d[j] = m.dlamda[j], indxq[j] = j;
    return 0;
  }
  for (int j = 0; j < n; ++j) m.coltyp[j] = j < n1 ? 1 : 3;
  int k2 = n, pj = -1;
  for (int j = 0; j < n; ++j) {
    const int nj = m.indx[j];
    if (rho * fabsf(m.z[nj]) <= tol) {  // a negligible z component
      m.coltyp[nj] = 4;
      m.indxp[--k2] = nj;
      continue;
    }
    if (pj < 0) {
      pj = nj;
      continue;
    }
    float s = m.z[pj], c = m.z[nj];
    const float tau = eig_slapy2(c, s), tt = d[nj] - d[pj];
    c = eig_div(c, tau);
    s = eig_div(-s, tau);
    if (fabsf(tt * c * s) <= tol) {  // two close eigenvalues: a rotation zeroes z(pj)
      m.z[nj] = tau;
      m.z[pj] = 0.0f;
      if (m.coltyp[nj] != m.coltyp[pj]) m.coltyp[nj] = 2;
      m.coltyp[pj] = 4;
      for (int r = 0; r < n; ++r) {  // OpenBLAS's srot
        const float x = Q[r + pj * ld], y = Q[r + nj * ld];
        Q[r + pj * ld] = __fmaf_rn(c, x, s * y);
        Q[r + nj * ld] = __fmaf_rn(c, y, -(s * x));
      }
      const float dp = d[pj], dn = d[nj];
      const float tp = dp * (c * c) + dn * (s * s);
      d[nj] = dp * (s * s) + dn * (c * c);
      d[pj] = tp;
      int at = --k2;
      while (at + 1 < n && d[pj] < d[m.indxp[at + 1]]) {
        m.indxp[at] = m.indxp[at + 1];
        ++at;
      }
      m.indxp[at] = pj;
    } else {
      m.dlamda[k] = d[pj];
      m.w[k] = m.z[pj];
      m.indxp[k++] = pj;
    }
    pj = nj;
  }
  m.dlamda[k] = d[pj];
  m.w[k] = m.z[pj];
  m.indxp[k++] = pj;
  // group the columns: 1 (top half only), 2 (both), 3 (bottom only), 4 (deflated)
  int ctot[4] = {0, 0, 0, 0}, psm[4];
  for (int j = 0; j < n; ++j) ++ctot[m.coltyp[j] - 1];
  psm[0] = 0;
  for (int q = 1; q < 4; ++q) psm[q] = psm[q - 1] + ctot[q - 1];
  for (int j = 0; j < n; ++j) {
    const int js = m.indxp[j], ct = m.coltyp[js] - 1;
    m.indx[psm[ct]] = js;
    m.indxc[psm[ct]++] = j;
  }
  // q2: the columns in that order (whole), their eigenvalues in z
  for (int j = 0; j < n; ++j) {
    const int js = m.indx[j];
    for (int r = 0; r < n; ++r) m.q2[r + j * n] = Q[r + js * ld];
    m.z[j] = d[js];
  }
  for (int j = k; j < n; ++j) {
    for (int r = 0; r < n; ++r) Q[r + j * ld] = m.q2[r + j * n];
    d[j] = m.z[j];
  }
  // ---- slaed3: the secular equation's roots and vectors
  int info = 0;
  for (int j = 0; j < k; ++j) {
    float* col = Q + j * ld;
    if (k == 1) {
      d[0] = m.dlamda[0] + rho * m.w[0] * m.w[0];
      col[0] = 1.0f;
    } else if (k == 2) {
      eig_slaed5(j + 1, m.dlamda, m.w, col, rho, &d[j]);
    } else {
      info = eig_slaed4(k, j + 1, m.dlamda, m.w, col, rho, &d[j]);
      if (info != 0) return info;
    }
  }
  if (k >= 3) {
    float wv[EIG_N];
    for (int q = 0; q < k; ++q) wv[q] = Q[q + q * ld];
    for (int j = 0; j < k; ++j)
      for (int q = 0; q < k; ++q)
        if (q != j) wv[q] = wv[q] * eig_div(Q[q + j * ld], m.dlamda[q] - m.dlamda[j]);
    for (int q = 0; q < k; ++q) wv[q] = copysignf(eig_sqrt(-wv[q]), m.w[q]);
    for (int j = 0; j < k; ++j) {
      float sv[EIG_N];
      for (int q = 0; q < k; ++q) sv[q] = eig_div(wv[q], Q[q + j * ld]);
      const float nrm = eig_snrm2(sv, k);
      for (int q = 0; q < k; ++q) Q[q + j * ld] = eig_div(sv[m.indxc[q]], nrm);
    }
  } else if (k == 2) {
    for (int j = 0; j < 2; ++j) {
      const float a = Q[0 + j * ld], b = Q[1 + j * ld];
      Q[0 + j * ld] = m.indxc[0] == 0 ? a : b;
      Q[1 + j * ld] = m.indxc[1] == 0 ? a : b;
    }
  }
  // sgemm (one FMA chain a value): the bottom rows from the columns of types 2, 3, the top from types 1, 2
  const int n12 = ctot[0] + ctot[1], n23 = ctot[1] + ctot[2];
  for (int j = 0; j < k; ++j)
    for (int q = 0; q < k; ++q) m.s[q + j * n] = Q[q + j * ld];
  for (int j = 0; j < k; ++j) {
    for (int r = n1; r < n; ++r) {
      float acc = 0.0f;
      for (int q = 0; q < n23; ++q) acc = __fmaf_rn(m.q2[r + (ctot[0] + q) * n], m.s[(ctot[0] + q) + j * n], acc);
      Q[r + j * ld] = acc;
    }
    for (int r = 0; r < n1; ++r) {
      float acc = 0.0f;
      for (int q = 0; q < n12; ++q) acc = __fmaf_rn(m.q2[r + q * n], m.s[q + j * n], acc);
      Q[r + j * ld] = acc;
    }
  }
  eig_slamrg(k, n - k, d, -1, indxq);
  return 0;
}

// sstedc, COMPZ = 'I' (Z column-major n x n): ssteqr for n <= SMLSIZ;
// otherwise split where |e_f| <= eps sqrt|d_f| sqrt|d_f+1|, blocks above
// SMLSIZ scaled to norm 1, cut in two halves (ssteqr each) and merged, the
// others ssteqr, then the selection sort
__device__ int eig_sstedc(float* d, float* e, float* Z, int n) {
  if (n <= EIG_SMLSIZ) return eig_ssteqr(d, e, Z, n, n);
  for (int j = 0; j < n; ++j)
    for (int i = 0; i < n; ++i) Z[i + j * n] = i == j ? 1.0f : 0.0f;
  if (eig_slanst(d, e, n) == 0.0f) return 0;
  const float eps = 0x1p-24f;
  EigMerge mw;
  int indxq[EIG_N];
  for (int start = 0; start < n;) {
    int finish = start;
    while (finish < n - 1 && fabsf(e[finish]) > eps * eig_sqrt(fabsf(d[finish])) * eig_sqrt(fabsf(d[finish + 1])))
      ++finish;
    const int m = finish - start + 1;
    if (m > EIG_SMLSIZ) {
      float* db = d + start;
      float* eb = e + start;
      float* Q = Z + start + start * n;
      const float nrm = eig_slanst(db, eb, m);
      eig_slascl(nrm, 1.0f, db, m, 1);
      eig_slascl(nrm, 1.0f, eb, m - 1, 1);
      const int n1 = m / 2;
      const float r = fabsf(eb[n1 - 1]);
      db[n1 - 1] = db[n1 - 1] - r;
      db[n1] = db[n1] - r;
      if (eig_ssteqr(db, eb, Q, n1, n) != 0 || eig_ssteqr(db + n1, eb + n1, Q + n1 + n1 * n, m - n1, n) != 0)
        return (start + 1) * (n + 1) + finish + 1;
      if (eig_slaed1(m, db, Q, n, indxq, eb[n1 - 1], n1, mw) != 0) return (start + 1) * (n + 1) + finish + 1;
      // re-merge in ascending order
      for (int j = 0; j < m; ++j) {
        mw.dlamda[j] = db[indxq[j]];
        for (int q = 0; q < m; ++q) mw.q2[q + j * m] = Q[q + indxq[j] * n];
      }
      for (int j = 0; j < m; ++j) {
        db[j] = mw.dlamda[j];
        for (int q = 0; q < m; ++q) Q[q + j * n] = mw.q2[q + j * m];
      }
      eig_slascl(1.0f, nrm, db, m, 1);
    } else if (m > 1) {
      if (eig_ssteqr(d + start, e + start, Z + start + start * n, m, n) != 0) return (start + 1) * (n + 1) + finish + 1;
    }
    start = finish + 1;
  }
  for (int ii = 2; ii <= n; ++ii) {  // selection sort
    const int i = ii - 1;
    int k = i;
    float p = d[i - 1];
    for (int j = ii; j <= n; ++j)
      if (d[j - 1] < p) {
        k = j;
        p = d[j - 1];
      }
    if (k != i) {
      d[k - 1] = d[i - 1];
      d[i - 1] = p;
      for (int r = 0; r < n; ++r) {
        const float t = Z[r + (i - 1) * n];
        Z[r + (i - 1) * n] = Z[r + (k - 1) * n];
        Z[r + (k - 1) * n] = t;
      }
    }
  }
  return 0;
}

// OpenBLAS's sgemv 'T' of one column a[0..m) with v by a postfix program
__device__ float eig_form(const int* ops, int len, const float* a, const float* v) {
  float st[EIG_N];
  int top = 0;
  for (int q = 0; q < len; ++q) {
    const int op = ops[q] >> 6, r = ops[q] & 63;
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

__global__ void syevd_small_kernel(const float* __restrict__ G, float* __restrict__ W, float* __restrict__ V,
                                   int* __restrict__ info_out, const int* __restrict__ ops,
                                   const int* __restrict__ offs, int B, int n) {
  const int bidx = blockIdx.x * blockDim.x + threadIdx.x;
  if (bidx >= B) return;
  float A[EIG_N * EIG_N], Z[EIG_N * EIG_N], d[EIG_N], e[EIG_N], tau[EIG_N], w[EIG_N], v[EIG_N];
  const float* g = G + (long long)bidx * n * n;
  for (int j = 0; j < n; ++j)
    for (int i = 0; i < n; ++i) A[i + j * n] = g[i * n + j];
  int info = 0;
  if (n == 1) {
    W[bidx] = A[0];
    V[(long long)bidx] = 1.0f;
    info_out[bidx] = 0;
    return;
  }
  // slansy('M', 'L') and the scaling of ssyevd
  float anrm = 0.0f;
  for (int j = 0; j < n; ++j)
    for (int i = j; i < n; ++i) {
      const float s = fabsf(A[i + j * n]);
      if (anrm < s || isnan(s)) anrm = s;
    }
  const float rmin = 0x1.6a09e6p-52f, rmax = 0x1.6a09e6p+51f;  // f32 sqrt(2^-103), sqrt(2^103)
  bool scaled = false;
  float sigma = 1.0f;
  if (anrm > 0.0f && anrm < rmin) {
    scaled = true;
    sigma = eig_div(rmin, anrm);
  } else if (anrm > rmax) {
    scaled = true;
    sigma = eig_div(rmax, anrm);
  }
  if (scaled)
    for (int j = 0; j < n; ++j) eig_slascl(1.0f, sigma, &A[j + j * n], n - j, 1);
  // ssytd2, lower
  for (int i = 0; i < n - 1; ++i) {
    float alpha = A[(i + 1) + i * n];
    float* x = &A[(i + 2) + i * n];
    const int k = n - i - 2;  // length of x
    float taui = 0.0f, beta = alpha;
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
    e[i] = beta;
    if (taui != 0.0f) {
      const int m = n - i - 1;
      A[(i + 1) + i * n] = 1.0f;
      const float* vv = &A[(i + 1) + i * n];
      float* S = &A[(i + 1) + (i + 1) * n];
      eig_symv(taui, S, n, vv, w, m);
      double dot = 0.0;
      for (int q = 0; q < m; ++q) dot = dot + (double)(w[q] * vv[q]);
      const float alph = (-0.5f * taui) * (float)dot;
      for (int q = 0; q < m; ++q) w[q] = __fmaf_rn(alph, vv[q], w[q]);
      for (int c = 0; c < m; ++c) {
        const float xc = -vv[c], yc = -w[c];
        for (int r = c; r < m; ++r) S[r + c * n] = __fmaf_rn(xc, w[r], S[r + c * n]);
        for (int r = c; r < m; ++r) S[r + c * n] = __fmaf_rn(yc, vv[r], S[r + c * n]);
      }
    }
    A[(i + 1) + i * n] = beta;
    d[i] = A[i + i * n];
    tau[i] = taui;
  }
  d[n - 1] = A[(n - 1) + (n - 1) * n];
  e[n - 1] = 0.0f;
  info = eig_sstedc(d, e, Z, n);
  // sormtr = sorm2r on Z(2:n, :), H(n - 1) first
  for (int i = n - 2; i >= 0; --i) {
    if (tau[i] == 0.0f) continue;
    const int m = n - 1 - i;
    v[0] = 1.0f;
    for (int q = 1; q < m; ++q) v[q] = A[(i + 1 + q) + i * n];
    int lastv = m;
    while (lastv > 0 && v[lastv - 1] == 0.0f) --lastv;
    float* C = &Z[1 + i];  // rows 1 + i .. n - 1, leading dimension n
    int lastc = 0;
    for (int j = n - 1; j >= 0 && lastc == 0; --j)
      for (int r = 0; r < lastv; ++r)
        if (C[r + j * n] != 0.0f) {
          lastc = j + 1;
          break;
        }
    if (lastv == 0 || lastc == 0) continue;
    const int n4 = lastc - lastc % 4;
    for (int j = 0; j < lastc; ++j) {
      const int kind = j < n4 ? 0 : (lastc % 4 & 2) && j < n4 + 2 ? 1 : 2;
      const int o = offs[kind * EIG_N + lastv];
      w[j] = eig_form(ops + o, offs[kind * EIG_N + lastv + 1] - o, C + j * n, v);
    }
    for (int j = 0; j < lastc; ++j) {
      const float t = -tau[i] * w[j];
      for (int r = 0; r < lastv; ++r) C[r + j * n] = __fmaf_rn(t, v[r], C[r + j * n]);
    }
  }
  if (scaled) {
    const float rs = eig_div(1.0f, sigma);
    for (int q = 0; q < n; ++q) d[q] = d[q] * rs;
  }
  for (int q = 0; q < n; ++q) W[(long long)bidx * n + q] = d[q];
  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c) V[(long long)bidx * n * n + r * n + c] = Z[r + c * n];
  info_out[bidx] = info;
}

TT_EXPORT int tt_syevd_small(const void* G, void* W, void* V, void* info, const void* ops, const void* offs, int B,
                             int n, void* stream_) {
  if (B < 0 || n < 1 || n > EIG_N) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  syevd_small_kernel<<<tt_blocks(B, 32), 32, 0, static_cast<cudaStream_t>(stream_)>>>(
      static_cast<const float*>(G), static_cast<float*>(W), static_cast<float*>(V), static_cast<int*>(info),
      static_cast<const int*>(ops), static_cast<const int*>(offs), B, n);
  return (int)cudaGetLastError();
}
