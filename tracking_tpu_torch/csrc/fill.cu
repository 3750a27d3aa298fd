// flood_reach: 4-connected reachability of background pixels from seed
// pixels, the core of SuBSENSE's cv::floodFill hole filling.
//
// Replaces tracking_tpu/ops/pallas_fill.py:flood_reach_pallas, whose TPU
// kernel propagates the seeds in sequential tile-raster passes repeated to a
// fixed point. Here: a union-find over background pixels in which the seeds
// are one more set, the index -1, smaller than every pixel index. Links
// always point to the smaller index, so a set that holds a seed has the root
// -1, and reach = reach0 | (bg & (root == -1)). Exact for any mask and any
// H, W, with no round cap. Three launches, no memset:
//   1. reach_local_kernel, one block per 32x32 tile: each warp takes a row
//      of the tile as a __ballot_sync bit mask; a pixel's run start comes
//      from the mask's bits, with no atomics; each pair of vertically
//      overlapping runs is joined once, at the first column of its overlap
//      (the strip scheme of Playne & Hawick's HA4, IEEE TPDS 2018), by a
//      shared-memory union. Every background pixel gets its tile root (a
//      global index), or -1 where its tile-local set holds a seed;
//   2. reach_border_kernel: one thread per pixel on a tile border, and a
//      global atomicMin union only at the first pixel of each run of
//      background pairs along the border (the rest are joined inside the
//      tiles already);
//   3. reach_out_kernel, 16 pixels a thread: a pixel's entry is its tile
//      root, whose entry after level 2 is its final root or a link towards
//      it. A longer chain is walked and every entry on it pointed at the
//      final root (the unions are done, so every writer writes the same
//      value), so later finds take two hops.
//
// Bound on the H100: latency, not bandwidth - the image is 0.9 MB of bools
// and the 3.7 MB parent array stays in the 50 MB L2. Background is most of
// a frame, so one set spans most tiles. The earlier design (common.cuh's
// pixel-wise unions, also used by label_components) made two contended
// shared-memory unions per background pixel; the runs make about one per
// run pair.
#include "common.cuh"

#define FR_T 32  // tile side
#define FR_WARPS 8

// The lane where this lane's run of set bits in m starts.
__device__ __forceinline__ int run_start(unsigned m, int lane) {
  const unsigned below = ~m & ((1u << lane) - 1u);
  return below ? 32 - __clz(below) : 0;
}

// Root of x (a pixel index, or -1 for the seeds, a root of itself). Parents
// only ever decrease, so a stale read is still an ancestor of x.
__device__ __forceinline__ int fr_find(const int* parent, int x) {
  while (x >= 0) {
    const int p = __ldcg(parent + x);
    if (p == x) return x;
    x = p;
  }
  return -1;
}

// Merge the sets of a and b, the larger root linked below the smaller.
__device__ __forceinline__ void fr_union(int* parent, int a, int b) {
  while (true) {
    a = fr_find(parent, a);
    b = fr_find(parent, b);
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

__global__ void __launch_bounds__(FR_T * FR_WARPS) reach_local_kernel(const bool* __restrict__ bg,
                                                                     const bool* __restrict__ reach0,
                                                                     int* __restrict__ parent, int H, int W) {
  __shared__ int s[FR_T * FR_T];
  __shared__ unsigned rows[FR_T];
  __shared__ unsigned char seeded[FR_T * FR_T];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int x = blockIdx.x * FR_T + lane, y0 = blockIdx.y * FR_T;
  constexpr int KR = FR_T / FR_WARPS;  // rows a warp takes: warp, warp + FR_WARPS, ...
  bool act[KR], seed[KR];
#pragma unroll
  for (int k = 0; k < KR; ++k) {  // every load first
    const int y = y0 + warp + FR_WARPS * k;
    const size_t i = (size_t)y * W + x;
    act[k] = x < W && y < H && bg[i];
    seed[k] = act[k] && reach0[i];
  }
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const int r = warp + FR_WARPS * k;
    const unsigned m = __ballot_sync(0xffffffffu, act[k]);
    if (lane == 0) rows[r] = m;
    s[r * FR_T + lane] = r * FR_T + run_start(m, lane);
    seeded[r * FR_T + lane] = 0;
  }
  __syncthreads();
  for (int r = warp; r < FR_T; r += FR_WARPS) {
    if (r == 0) continue;
    const unsigned both = rows[r] & rows[r - 1];
    if (((both & ~(both << 1)) >> lane) & 1u) suf_union(s, r * FR_T + lane, (r - 1) * FR_T + lane);
  }
  __syncthreads();
  int root[KR];
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    root[k] = act[k] ? suf_find(s, (warp + FR_WARPS * k) * FR_T + lane) : -1;
    if (seed[k]) seeded[root[k]] = 1;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const int rt = root[k];
    if (rt >= 0) {
      const int r = warp + FR_WARPS * k;
      parent[(size_t)(y0 + r) * W + x] = seeded[rt] ? -1 : (y0 + rt / FR_T) * W + blockIdx.x * FR_T + rt % FR_T;
    }
  }
}

// The edges across tile borders: rows y = 32, 64, ... against the row above,
// then columns x = 32, 64, ... against the column to the left.
__global__ void reach_border_kernel(const bool* __restrict__ bg, int* parent, int H, int W) {
  const int nh = ((H - 1) / FR_T) * W;
  const int nv = ((W - 1) / FR_T) * H;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nh) {
    const int y = (i / W + 1) * FR_T, x = i % W;
    const int q = y * W + x;
    if (bg[q] && bg[q - W] && (x % FR_T == 0 || !(bg[q - 1] && bg[q - W - 1]))) fr_union(parent, q, q - W);
  } else if (i < nh + nv) {
    const int j = i - nh;
    const int x = (j / H + 1) * FR_T, y = j % H;
    const int q = y * W + x;
    if (bg[q] && bg[q - 1] && (y % FR_T == 0 || !(bg[q - W] && bg[q - W - 1]))) fr_union(parent, q, q - 1);
  }
}

// Whether the set of entry p (a pixel's parent entry) holds a seed.
__device__ __forceinline__ bool fr_seeded(int* parent, int p) {
  if (p < 0) return true;
  const int q = __ldcg(parent + p);
  if (q == p) return false;
  if (q < 0) return true;
  const int r = fr_find(parent, q);
  for (int x = p; x >= 0 && x != r;) {  // point the path at its final root
    const int nx = __ldcg(parent + x);
    if (nx != r) __stcg(parent + x, r);
    x = nx;
  }
  return r < 0;
}

__global__ void reach_out_kernel(const bool* __restrict__ bg, const bool* __restrict__ reach0, int* parent,
                                 bool* __restrict__ out, int n, int vec) {
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * 16;
  if (i0 >= n) return;
  int last_p = 0;
  bool last_s = false, have = false;
  if (vec && i0 + 16 <= n) {
    const uint4 b = *reinterpret_cast<const uint4*>(bg + i0);
    const uint4 r = *reinterpret_cast<const uint4*>(reach0 + i0);
    const uint32_t bw[4] = {b.x, b.y, b.z, b.w}, rw[4] = {r.x, r.y, r.z, r.w};
    uint32_t ow[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      ow[w] = rw[w];
      const uint32_t open = bw[w] & ~rw[w];  // background not in reach0
      if (open) {
        const int4 pv = *reinterpret_cast<const int4*>(parent + i0 + 4 * w);
        const int pp[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if ((open >> (8 * k)) & 1u) {
            if (!have || pp[k] != last_p) {
              last_p = pp[k];
              last_s = fr_seeded(parent, last_p);
              have = true;
            }
            if (last_s) ow[w] |= 1u << (8 * k);
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(out + i0) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
  } else {
    const int i1 = min(i0 + 16, n);
    for (int i = i0; i < i1; ++i) {
      bool o = reach0[i];
      if (!o && bg[i]) {
        const int p = parent[i];
        if (!have || p != last_p) {
          last_p = p;
          last_s = fr_seeded(parent, p);
          have = true;
        }
        o = last_s;
      }
      out[i] = o;
    }
  }
}

TT_EXPORT int tt_flood_reach(const void* bg_, const void* reach0_, void* parent_, void* out_, int H, int W,
                             void* stream_) {
  const bool* bg = static_cast<const bool*>(bg_);
  const bool* reach0 = static_cast<const bool*>(reach0_);
  int* parent = static_cast<int*>(parent_);
  bool* out = static_cast<bool*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int n = H * W, threads = 256;
  if (n == 0) return 0;
  dim3 tiles((W + FR_T - 1) / FR_T, (H + FR_T - 1) / FR_T);
  reach_local_kernel<<<tiles, dim3(FR_T, FR_WARPS), 0, stream>>>(bg, reach0, parent, H, W);
  const int n_border = ((H - 1) / FR_T) * W + ((W - 1) / FR_T) * H;
  if (n_border > 0) reach_border_kernel<<<tt_blocks(n_border, threads), threads, 0, stream>>>(bg, parent, H, W);
  const bool vec = ((uintptr_t)bg | (uintptr_t)reach0 | (uintptr_t)parent | (uintptr_t)out) % 16 == 0;
  reach_out_kernel<<<tt_blocks((n + 15) / 16, threads), threads, 0, stream>>>(bg, reach0, parent, out, n,
                                                                             vec ? 1 : 0);
  return (int)cudaGetLastError();
}

TT_EXPORT const char* tt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
