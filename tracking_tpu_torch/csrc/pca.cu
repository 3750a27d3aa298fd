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
// syevd_small: LAPACK's ssyevd('V', 'L') for n <= 25 as jaxlib runs it
// (ops/eigh.py's module note has the orders): slansy's scaling test and
// slascl, ssytd2 (slarfg with OpenBLAS's snrm2, ssymv, sdot, saxpy, ssyr2),
// ssteqr (QL / QR with slaev2, slartg, slapy2, slascl, selection sort) and
// sorm2r (sgemv 'T' by the postfix programs of ops/eigh.py's forms, sger).
// One thread a matrix, LAPACK's scalar order; __fmaf_rn exactly where
// OpenBLAS's kernels fuse, every other operation rounded on its own
// (-fmad=false). It runs once a video, at t == historySize.
//
// Replaces no TPU kernel: the JAX package calls jnp.linalg.eigh
// (tracking_tpu/bgs/eigenbackground.py:71), one LAPACK custom call.

#define EIG_N 25
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

// slasr's plane (j, j + 1) (1-based columns) of Z (column-major, n x n)
__device__ __forceinline__ void eig_rot(float* Z, int n, int j, float ct, float st) {
  if (ct == 1.0f && st == 0.0f) return;
  float* a = Z + (j - 1) * n;
  float* b = Z + j * n;
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

// ssteqr, COMPZ = 'I'; d[n], e[n] (e[n - 1] spare), Z column-major; returns info
__device__ int eig_ssteqr(float* d, float* e, float* Z, int n) {
  for (int i = 0; i < n * n; ++i) Z[i] = 0.0f;
  for (int i = 0; i < n; ++i) Z[i + i * n] = 1.0f;
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
          eig_rot(Z, n, l, c, s);
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
          eig_rot(Z, n, i, c, -s);
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
          eig_rot(Z, n, l - 1, c, s);
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
          eig_rot(Z, n, i, c, s);
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
        const float t = Z[r + (i - 1) * n];
        Z[r + (i - 1) * n] = Z[r + (k - 1) * n];
        Z[r + (k - 1) * n] = t;
      }
    }
  }
#undef D
#undef E
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
  info = eig_ssteqr(d, e, Z, n);
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
      const int o = offs[kind * 26 + lastv];
      w[j] = eig_form(ops + o, offs[kind * 26 + lastv + 1] - o, C + j * n, v);
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
