// flood_reach: 4-connected reachability of background pixels from seed
// pixels, the core of SuBSENSE's cv::floodFill hole filling.
//
// Replaces tracking_tpu/ops/pallas_fill.py:flood_reach_pallas, whose TPU
// kernel propagates the seeds in sequential tile-raster passes repeated to a
// fixed point. Here: the run-based union-find of common.cuh over background
// pixels, in which the seeds are one more set, the index -1, smaller than
// every pixel index. Links always point to the smaller index, so a set that
// holds a seed has the root -1, and reach = reach0 | (bg & (root == -1)).
// Exact for any mask and any H, W, with no round cap. Three launches, no
// memset:
//   1. reach_local_kernel, one block per 32x32 tile: level 1 of common.cuh
//      (ballot run starts, one shared union per pair of vertically
//      overlapping runs); every background pixel gets its tile root (a
//      global index), or -1 where its tile-local set holds a seed;
//   2. uf_border_kernel<false> (common.cuh): a global atomicMin union only
//      at the first pixel of each run of background pairs along a tile
//      border (the rest are joined inside the tiles already);
//   3. reach_out_kernel, 16 pixels a thread: a pixel's entry is its tile
//      root, whose entry after level 2 is its final root or a link towards
//      it; uf_resolve walks a longer chain and points every entry on it at
//      the final root, so later finds take two hops.
//
// Bound on the H100: latency, not bandwidth - the image is 0.9 MB of bools
// and the 3.7 MB parent array stays in the 50 MB L2. Background is most of
// a frame, so one set spans most tiles; the runs make about one union per
// pair of runs where pixel-wise unions made two contended ones per pixel.
#include "common.cuh"

__global__ void __launch_bounds__(UF_T * UF_WARPS) reach_local_kernel(const bool* __restrict__ bg,
                                                                     const bool* __restrict__ reach0,
                                                                     int* __restrict__ parent, int H, int W) {
  __shared__ int s[UF_T * UF_T];
  __shared__ unsigned rows[UF_T];
  __shared__ unsigned char seeded[UF_T * UF_T];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int x = blockIdx.x * UF_T + lane, y0 = blockIdx.y * UF_T;
  bool act[UF_KR], seed[UF_KR];
#pragma unroll
  for (int k = 0; k < UF_KR; ++k) {  // every load first
    const int y = y0 + warp + UF_WARPS * k;
    const size_t i = (size_t)y * W + x;
    act[k] = x < W && y < H && bg[i];
    seed[k] = act[k] && reach0[i];
    seeded[(warp + UF_WARPS * k) * UF_T + lane] = 0;
  }
  int root[UF_KR];
  uf_tile_roots<false>(act, s, rows, root);
#pragma unroll
  for (int k = 0; k < UF_KR; ++k)
    if (seed[k]) seeded[root[k]] = 1;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < UF_KR; ++k) {
    const int rt = root[k];
    if (rt >= 0) {
      const int r = warp + UF_WARPS * k;
      parent[(size_t)(y0 + r) * W + x] = seeded[rt] ? -1 : (y0 + rt / UF_T) * W + blockIdx.x * UF_T + rt % UF_T;
    }
  }
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
              last_s = uf_resolve(parent, last_p) < 0;
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
          last_s = uf_resolve(parent, p) < 0;
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
  dim3 tiles((W + UF_T - 1) / UF_T, (H + UF_T - 1) / UF_T);
  reach_local_kernel<<<tiles, dim3(UF_T, UF_WARPS), 0, stream>>>(bg, reach0, parent, H, W);
  uf_border<false>(bg, parent, H, W, stream);
  const bool vec = ((uintptr_t)bg | (uintptr_t)reach0 | (uintptr_t)parent | (uintptr_t)out) % 16 == 0;
  reach_out_kernel<<<tt_blocks((n + 15) / 16, threads), threads, 0, stream>>>(bg, reach0, parent, out, n,
                                                                             vec ? 1 : 0);
  return (int)cudaGetLastError();
}

TT_EXPORT const char* tt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
