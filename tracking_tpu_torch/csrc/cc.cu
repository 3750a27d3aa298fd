// Two kernels on the run-based union-find of common.cuh, 8- or 4-connected:
//
// label_components: connected components of a binary mask. A label is the
// component's minimum row-major pixel index; background is -1. Replaces
// tracking_tpu/ops/pallas_cc.py:label_components_pallas, whose TPU kernel
// runs sequential tile-raster min-label propagation (_raster_pass) to a
// fixed point.
//
// label_fixpoint: the min-label fixed point from arbitrary initial labels:
// for each foreground pixel, the minimum of lab0 over its component (inside
// this image, one shard's slab on the row-sharded path); `big` on
// background. Replaces pallas_cc.py:label_fixpoint_pallas, whose TPU kernel
// repeats forward and backward raster passes until nothing changes. lab0
// need not be ordered like pixel indices (the sharded caller injects a
// neighbour's smaller labels into its boundary rows), so the union-find
// groups the pixels by component (root = minimum index) and the minimum of
// lab0 is folded beside it with integer mins, which are order-free and so
// exact with atomics.
//
// Launches, with no data-dependent loop and no device copy:
//   1. cc_local_kernel, one block per 32x32 tile: level 1 of common.cuh.
//      Each foreground pixel gets its tile root (a global index). For the
//      fixed point, each run's lab0 minimum is taken by a segmented warp
//      scan and folded into its tile root by one shared atomicMin a run;
//      out holds the tile set's minimum at the tile root, INT_MAX at the
//      other foreground pixels;
//   2. uf_border_kernel (common.cuh): unions across tile borders, only at
//      the first pixel of each run of pairs along a border, and 8-connected
//      at diagonals with both 4-neighbours in between inactive (across a
//      border or a tile corner);
//   3. the fixed point only: fix_fold_kernel, 4 pixels a thread. Each tile
//      root finds its final root, points its chain at it and, if it is not
//      the root itself, folds its minimum into the root's entry of out by
//      one global atomicMin;
//   4. cc_out_kernel, 4 pixels a thread with 16-byte label loads and stores
//      where aligned: a pixel's entry is its tile root; the root of the last
//      entry seen is cached, and a chain is walked once and pointed at its
//      final root. label_components writes the root, or -1; the fixed point
//      the root's entry of out, or big.
// So 3 launches for label_components, 4 for label_fixpoint.
//
// label_components uses its output buffer as the parent array. Chains pass
// only through foreground pixels, and every write of the last launch puts
// a foreground pixel's final root (an ancestor) or -1 on a background pixel
// (on no chain), so a walker is never handed a non-ancestor.
//
// Bound on the H100: latency and launches, not bandwidth. The bytes are 5
// B/px for CC (mask in, labels out) and 9 B/px for the fixed point (fg,
// lab0, labels), 1.4 us and 0.6 us at 720p and on a 180-row shard; the
// parent array stays in the 50 MB L2. Each level is a few microseconds of
// dependent L2 reads and barriers, so the 3 or 4 launches and the wrapper's
// host time per call, not bytes, set the floor. The runs make about one shared union
// per pair of touching runs, where the pixel-wise scheme made up to four
// contended ones per foreground pixel; a dense mask has fewer runs a pixel.
// One component across every tile (a flooded mask) takes one border union
// per run of pairs, all into one root.
#include <limits.h>

#include "common.cuh"

// FIX: also fold lab0 (the fixed point); else lab0 and out are unused.
template <bool CONN8, bool FIX>
__global__ void __launch_bounds__(UF_T * UF_WARPS) cc_local_kernel(const uint8_t* __restrict__ fg,
                                                                  const int* __restrict__ lab0,
                                                                  int* __restrict__ parent,
                                                                  int* __restrict__ out, int H, int W) {
  __shared__ int s[UF_T * UF_T];
  __shared__ unsigned rows[UF_T];
  __shared__ int smin[FIX ? UF_T * UF_T : 1];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int x = blockIdx.x * UF_T + lane, y0 = blockIdx.y * UF_T;
  bool act[UF_KR];
  int v[UF_KR];
#pragma unroll
  for (int k = 0; k < UF_KR; ++k) {  // every load first
    const int y = y0 + warp + UF_WARPS * k;
    const size_t i = (size_t)y * W + x;
    act[k] = x < W && y < H && fg[i] != 0;
    if (FIX) {
      v[k] = act[k] ? lab0[i] : INT_MAX;
      smin[(warp + UF_WARPS * k) * UF_T + lane] = INT_MAX;
    }
  }
  int root[UF_KR];
  uf_tile_roots<CONN8>(act, s, rows, root);
  if (FIX) {
#pragma unroll
    for (int k = 0; k < UF_KR; ++k) {
      const unsigned m = rows[warp + UF_WARPS * k];
      const int start = run_start(m, lane);
      int mv = v[k];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {  // min over [max(start, lane - 2d + 1), lane]
        const int o = __shfl_up_sync(0xffffffffu, mv, d);
        if (lane - d >= start) mv = min(mv, o);
      }
      if (act[k] && (lane == 31 || !((m >> (lane + 1)) & 1u))) atomicMin(smin + root[k], mv);  // run's last lane
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < UF_KR; ++k) {
    const int rt = root[k];
    if (rt >= 0) {
      const int l = (warp + UF_WARPS * k) * UF_T + lane;
      const size_t g = (size_t)(y0 + warp + UF_WARPS * k) * W + x;
      parent[g] = (y0 + rt / UF_T) * W + blockIdx.x * UF_T + rt % UF_T;
      if (FIX) out[g] = rt == l ? smin[l] : INT_MAX;
    }
  }
}

// Pixels a thread in levels 3 and 4 (a multiple of 4): their finds wait on
// L2, so more threads hide more of it (4 took 0.0067 ms at 720p where 8 took
// 0.0100 and 16 took 0.0140, NVIDIA H100 80GB HBM3 at 700 W).
#define CC_PX 4

// The tile roots (out below INT_MAX; a root whose minimum is INT_MAX has
// nothing to fold) fold their minimum into their final root's entry. Only
// final roots' entries change, and a final root folds into no entry.
__global__ void fix_fold_kernel(const uint8_t* __restrict__ fg, int* parent, int* out, int n, int vec) {
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * CC_PX;
  if (i0 >= n) return;
  if (vec && i0 + CC_PX <= n) {
#pragma unroll
    for (int w = 0; w < CC_PX / 4; ++w) {
      const uint32_t b = *reinterpret_cast<const uint32_t*>(fg + i0 + 4 * w);
      if (!b) continue;
      const int4 ov = *reinterpret_cast<const int4*>(out + i0 + 4 * w);
      const int o[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + 4 * w + k;
        if (((b >> (8 * k)) & 0xffu) && o[k] != INT_MAX) {
          const int r = uf_resolve(parent, i);
          if (r != i) atomicMin(out + r, o[k]);
        }
      }
    }
  } else {
    const int i1 = min(i0 + CC_PX, n);
    for (int i = i0; i < i1; ++i) {
      if (!fg[i]) continue;
      const int o = out[i];
      if (o == INT_MAX) continue;
      const int r = uf_resolve(parent, i);
      if (r != i) atomicMin(out + r, o);
    }
  }
}

// FIX: out[i] = out[root] (each thread writes its own entries and reads
// only final roots', whose own thread writes back the value it reads),
// else out (the parent array itself) = root. Background gets bg_value.
template <bool FIX>
__global__ void cc_out_kernel(const uint8_t* __restrict__ fg, int* parent, int* out, int n, int bg_value,
                              int vec) {
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * CC_PX;
  if (i0 >= n) return;
  int last_p = -1, last_v = 0;  // entries are >= 0, so -1 caches nothing
  if (vec && i0 + CC_PX <= n) {
#pragma unroll
    for (int w = 0; w < CC_PX / 4; ++w) {
      const uint32_t b = *reinterpret_cast<const uint32_t*>(fg + i0 + 4 * w);
      int o[4] = {bg_value, bg_value, bg_value, bg_value};
      if (b) {
        const int4 pv = *reinterpret_cast<const int4*>(parent + i0 + 4 * w);
        const int pp[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if ((b >> (8 * k)) & 0xffu) {
            if (pp[k] != last_p) {
              last_p = pp[k];
              const int r = uf_resolve(parent, last_p);
              last_v = FIX ? __ldcg(out + r) : r;
            }
            o[k] = last_v;
          }
        }
      }
      *reinterpret_cast<int4*>(out + i0 + 4 * w) = make_int4(o[0], o[1], o[2], o[3]);
    }
  } else {
    const int i1 = min(i0 + CC_PX, n);
    for (int i = i0; i < i1; ++i) {
      int o = bg_value;
      if (fg[i]) {
        const int p = parent[i];
        if (p != last_p) {
          last_p = p;
          const int r = uf_resolve(parent, p);
          last_v = FIX ? __ldcg(out + r) : r;
        }
        o = last_v;
      }
      out[i] = o;
    }
  }
}

template <bool CONN8, bool FIX>
static void cc_levels(const uint8_t* fg, const int* lab0, int* parent, int* out, int H, int W, cudaStream_t stream) {
  dim3 tiles((W + UF_T - 1) / UF_T, (H + UF_T - 1) / UF_T);
  cc_local_kernel<CONN8, FIX><<<tiles, dim3(UF_T, UF_WARPS), 0, stream>>>(fg, lab0, parent, out, H, W);
  uf_border<CONN8>(fg, parent, H, W, stream);
}

static bool aligned16(const void* a, const void* b, const void* c) {
  return ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16 == 0;
}

TT_EXPORT int tt_label_components(const void* fg_, void* out_, int H, int W, int connectivity, void* stream_) {
  const uint8_t* fg = static_cast<const uint8_t*>(fg_);
  int* lab = static_cast<int*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int n = H * W, threads = 256;
  if (n == 0) return 0;
  if (connectivity == 8) {
    cc_levels<true, false>(fg, nullptr, lab, nullptr, H, W, stream);
  } else {
    cc_levels<false, false>(fg, nullptr, lab, nullptr, H, W, stream);
  }
  cc_out_kernel<false><<<tt_blocks((n + CC_PX - 1) / CC_PX, threads), threads, 0, stream>>>(fg, lab, lab, n, -1,
                                                                                 aligned16(fg, lab, lab));
  return (int)cudaGetLastError();
}

TT_EXPORT int tt_label_fixpoint(const void* fg_, const void* lab0_, void* parent_, void* out_, int H, int W,
                                int connectivity, int big, void* stream_) {
  const uint8_t* fg = static_cast<const uint8_t*>(fg_);
  const int* lab0 = static_cast<const int*>(lab0_);
  int* parent = static_cast<int*>(parent_);
  int* out = static_cast<int*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int n = H * W, threads = 256;
  if (n == 0) return 0;
  if (connectivity == 8) {
    cc_levels<true, true>(fg, lab0, parent, out, H, W, stream);
  } else {
    cc_levels<false, true>(fg, lab0, parent, out, H, W, stream);
  }
  const int vec = aligned16(fg, parent, out);
  fix_fold_kernel<<<tt_blocks((n + CC_PX - 1) / CC_PX, threads), threads, 0, stream>>>(fg, parent, out, n, vec);
  cc_out_kernel<true><<<tt_blocks((n + CC_PX - 1) / CC_PX, threads), threads, 0, stream>>>(fg, parent, out, n, big, vec);
  return (int)cudaGetLastError();
}
