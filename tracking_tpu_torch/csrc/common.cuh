// Shared helpers of the port's CUDA kernels: the export macro, XLA:CPU's
// f32 exp (xla_expf, below) and a run-based two-level union-find over the
// "active" pixels of an image (background for the hole fill in fill.cu,
// foreground for the CC labelling in cc.cu). Links always point to the
// smaller index, so every root is the minimum row-major index of its set;
// fill.cu adds one more set, the index -1, below every pixel, which the
// find and the union below accept.
//
// Level 1 (uf_tile_roots, inside each caller's tile kernel): one block of
// 8 warps per 32x32 tile. Each warp takes a row of the tile as a
// __ballot_sync bit mask, and a pixel's run start comes from the mask's
// bits (run_start), with no atomics: a run is one set from the start. Then
// one shared-memory union per pair of touching runs in neighbouring rows
// (the strip scheme of Playne & Hawick's HA4, IEEE TPDS 2018):
//   - 4-connected, the pair's first column of overlap (the first bit of
//     each segment of row & up);
//   - 8-connected, a run touches each run above whose span, widened by one
//     column on each side, overlaps it. The run's start lane joins each run
//     above at the first bit of that run inside the widened span (a contact
//     segment of row & (up | up << 1 | up >> 1) can span two runs above:
//     above 11011, below 11111).
// A tile-local index order is the global row-major order restricted to the
// tile, so tile roots are global minima too.
// Level 2 (uf_border_kernel): global atomicMin unions across tile borders,
// only at the first pixel of each run of pairs along a border; 8-connected,
// also each diagonal pair across a border or a tile corner whose two
// 4-neighbours in between are both inactive (otherwise 4-edges, joined
// already, connect it).
//
// The pixel-wise two-level union-find that stood here before (a shared
// union per pixel and neighbour over 32x16 tiles) made up most of the time
// of the fill and of both CC kernels; the runs make about one union per
// pair of runs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TT_EXPORT extern "C" __attribute__((visibility("default")))
#define UF_T 32     // tile side
#define UF_WARPS 8  // a warp takes the rows warp, warp + UF_WARPS, ...
#define UF_KR (UF_T / UF_WARPS)

inline unsigned tt_blocks(int n, int threads) { return (unsigned)((n + threads - 1) / threads); }

// XLA:CPU's f32 exp, step for step as ops/xla_math.exp writes it: the
// Cephes range reduction exp(x) = 2^n (1 + r + r^2 P(r)), n = floor(x
// log2(e) + 1/2), r = x - n ln 2 (ln 2 split in two), with __fmaf_rn at
// exactly the multiply-adds XLA's compiled code contracts (the build's
// -fmad=false keeps every other product and sum rounded on its own). x is
// clamped to [-87.8, 88.8] and n to [-127, 127] (2^-127 is encoded as +0),
// and a result below the smallest normal is flushed to 0, as XLA:CPU does.
// libdevice's expf differs from it by an ulp on some arguments.
__device__ __forceinline__ float xla_expf(float x) {
  const float xc = x < __uint_as_float(0xc2af999au) ? __uint_as_float(0xc2af999au)
                   : x > __uint_as_float(0x42b1999au) ? __uint_as_float(0x42b1999au) : x;  // NaN passes
  const float n = fminf(fmaxf(floorf(__fmaf_rn(xc, __uint_as_float(0x3fb8aa3bu), 0.5f)), -127.0f), 127.0f);
  float r = __fmaf_rn(-n, __uint_as_float(0x3f318000u), xc);  // ln 2 = 0.693359375 - (-2.12194440e-4)
  r = __fmaf_rn(-n, __uint_as_float(0xb95e8083u), r);
  float y = __fmaf_rn(r, __uint_as_float(0x39506967u), __uint_as_float(0x3ab743ceu));
  y = __fmaf_rn(y, r, __uint_as_float(0x3c088908u));
  y = __fmaf_rn(y, r, __uint_as_float(0x3d2aa9c1u));
  y = __fmaf_rn(y, r, __uint_as_float(0x3e2aaaaau));
  y = __fmaf_rn(y, r, 0.5f);
  y = __fmaf_rn(y, r * r, r) + 1.0f;
  const float e = y * __int_as_float(((int)n + 127) << 23);
  return e < __uint_as_float(0x00800000u) ? 0.0f : e;  // the smallest normal
}

// The lane where this lane's run of set bits in m starts.
__device__ __forceinline__ int run_start(unsigned m, int lane) {
  const unsigned below = ~m & ((1u << lane) - 1u);
  return below ? 32 - __clz(below) : 0;
}

// Root of x (a pixel index, or -1, a root of itself) in a global parent
// array. Parents only ever decrease (atomicMin), so a stale read is still an
// ancestor of x and the walk ends at the current root. __ldcg reads L2,
// which the atomics update.
__device__ __forceinline__ int uf_find(const int* parent, int x) {
  while (x >= 0) {
    const int p = __ldcg(parent + x);
    if (p == x) return x;
    x = p;
  }
  return -1;
}

// Merge the sets of a and b: the larger root is linked below the smaller
// one, retried until it lands on a root.
__device__ __forceinline__ void uf_union(int* parent, int a, int b) {
  while (true) {
    a = uf_find(parent, a);
    b = uf_find(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

// Final root of entry p once every union is done, with each entry on the
// walked chain pointed at it (every writer writes the same value), so later
// finds take two hops.
__device__ __forceinline__ int uf_resolve(int* parent, int p) {
  if (p < 0) return p;
  const int q = __ldcg(parent + p);
  if (q == p || q < 0) return q;
  const int r = uf_find(parent, q);
  for (int x = p; x >= 0 && x != r;) {
    const int nx = __ldcg(parent + x);
    if (nx != r) __stcg(parent + x, r);
    x = nx;
  }
  return r;
}

// The same find and union on a shared-memory array of tile-local indices.
__device__ __forceinline__ int suf_find(volatile int* s, int x) {
  int p = s[x];
  while (p != x) {
    x = p;
    p = s[x];
  }
  return x;
}

__device__ __forceinline__ void suf_union(int* s, int a, int b) {
  while (true) {
    a = suf_find(s, a);
    b = suf_find(s, b);
    if (a < b) {
      int old = atomicMin(s + b, a);
      if (old == b) return;
      b = old;
    } else if (b < a) {
      int old = atomicMin(s + a, b);
      if (old == a) return;
      a = old;
    } else {
      return;
    }
  }
}

// Level 1 for a block of (UF_T, UF_WARPS) threads: act[k] says whether this
// lane's pixel in tile row warp + UF_WARPS * k is active; rows[] receives
// the tile's row masks and s[] the tile-local union-find. root[k] is the
// pixel's tile-local root (row * UF_T + column), -1 where inactive.
template <bool CONN8>
__device__ __forceinline__ void uf_tile_roots(const bool (&act)[UF_KR], int* s, unsigned* rows,
                                              int (&root)[UF_KR]) {
  const int lane = threadIdx.x, warp = threadIdx.y;
#pragma unroll
  for (int k = 0; k < UF_KR; ++k) {
    const int r = warp + UF_WARPS * k;
    const unsigned m = __ballot_sync(0xffffffffu, act[k]);
    if (lane == 0) rows[r] = m;
    s[r * UF_T + lane] = r * UF_T + run_start(m, lane);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < UF_KR; ++k) {
    const int r = warp + UF_WARPS * k;
    if (r == 0 || !act[k]) continue;
    const unsigned m = rows[r], up = rows[r - 1];
    if (!CONN8) {
      const unsigned both = m & up;
      if (((both & ~(both << 1)) >> lane) & 1u) suf_union(s, r * UF_T + lane, (r - 1) * UF_T + lane);
    } else if (run_start(m, lane) == lane) {
      const unsigned rest = ~(m >> lane);  // 0 only for a run over the whole row
      const int len = rest ? __ffs(rest) - 1 : 32;
      const unsigned run = (len == 32 ? ~0u : (1u << len) - 1u) << lane;
      const unsigned w = up & (run | (run << 1) | (run >> 1));
      for (unsigned first = w & ~(w << 1); first; first &= first - 1u)
        suf_union(s, r * UF_T + lane, (r - 1) * UF_T + __ffs(first) - 1);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < UF_KR; ++k) root[k] = act[k] ? suf_find(s, (warp + UF_WARPS * k) * UF_T + lane) : -1;
}

// Level 2, one thread per border pixel: rows y = 32, 64, ... against the row
// above, then columns x = 32, 64, ... against the column to the left.
template <bool CONN8>
__global__ void uf_border_kernel(const uint8_t* __restrict__ active, int* parent, int H, int W) {
  const int nh = ((H - 1) / UF_T) * W;
  const int nv = ((W - 1) / UF_T) * H;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  auto on = [&](int p) { return active[p] != 0; };
  if (i < nh) {
    const int y = (i / W + 1) * UF_T, x = i % W;
    const int q = y * W + x;
    if (!on(q)) return;
    const bool up = on(q - W);
    if (up && (x % UF_T == 0 || !(on(q - 1) && on(q - W - 1)))) uf_union(parent, q, q - W);
    if (CONN8 && !up) {  // the diagonals up from (y, x)
      if (x > 0 && on(q - W - 1) && !on(q - 1)) uf_union(parent, q, q - W - 1);
      if (x + 1 < W && on(q - W + 1) && !on(q + 1)) uf_union(parent, q, q - W + 1);
    }
  } else if (i < nh + nv) {
    const int j = i - nh;
    const int x = (j / H + 1) * UF_T, y = j % H;
    const int q = y * W + x;
    const bool a = on(q), left = on(q - 1);
    if (a && left && (y % UF_T == 0 || !(on(q - W) && on(q - W - 1)))) uf_union(parent, q, q - 1);
    if (CONN8 && y % UF_T != 0 && a != left) {  // the diagonals across the column (row y's are level 2's above)
      if (a && on(q - W - 1) && !on(q - W)) uf_union(parent, q, q - W - 1);
      if (left && on(q - W) && !on(q - W - 1)) uf_union(parent, q - 1, q - W);
    }
  }
}

// Level 2's launch, where the image has a tile border. Any nonzero byte of
// `active` is active.
template <bool CONN8>
static inline void uf_border(const void* active, int* parent, int H, int W, cudaStream_t stream) {
  const int n_border = ((H - 1) / UF_T) * W + ((W - 1) / UF_T) * H;
  if (n_border > 0)
    uf_border_kernel<CONN8><<<tt_blocks(n_border, 256), 256, 0, stream>>>(static_cast<const uint8_t*>(active),
                                                                          parent, H, W);
}
