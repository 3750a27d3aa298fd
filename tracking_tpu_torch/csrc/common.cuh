// Shared helpers of the port's CUDA kernels: export macro and a two-level
// union-find over the "active" pixels of an image (background for the hole
// fill, foreground for CC labelling) whose links always point to the
// smaller row-major index, so every root is the minimum index of its set.
//
// Level 1 (uf_local_kernel): one thread block per 32x16 tile runs the
// union-find in shared memory, where atomics are cheap and chains short,
// and writes each pixel's tile-local root (a global index) to `parent`.
// Level 2 (uf_border_kernel): only pixels with a neighbour in another tile
// link across the border, with global atomicMin. A tile-local index order
// is the global row-major order restricted to the tile, so tile minima are
// global minima.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TT_EXPORT extern "C" __attribute__((visibility("default")))
#define UF_TX 32
#define UF_TY 16

inline unsigned tt_blocks(int n, int threads) { return (unsigned)((n + threads - 1) / threads); }

// Root of x in a global parent array. Parents only ever decrease
// (atomicMin), so a stale read is still an ancestor of x and the walk ends
// at the current root. __ldcg reads L2, which the atomics update.
__device__ __forceinline__ int uf_find(const int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    x = p;
    p = __ldcg(parent + x);
  }
  return x;
}

// Merge the sets of a and b: the larger root is linked to the smaller one
// (Playne & Hawick's atomicMin union, retried until it lands on a root).
__device__ __forceinline__ void uf_union(int* parent, int a, int b) {
  while (true) {
    a = uf_find(parent, a);
    b = uf_find(parent, b);
    if (a < b) {
      int old = atomicMin(parent + b, a);
      if (old == b) return;
      b = old;
    } else if (b < a) {
      int old = atomicMin(parent + a, b);
      if (old == a) return;
      a = old;
    } else {
      return;
    }
  }
}

// The same two operations on a shared-memory array of tile-local indices.
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

// Level 1. Launch with block (UF_TX, UF_TY) and one block per tile. Every
// pixel gets a parent (inactive pixels point to themselves). Each active
// pixel links to its active "backward" neighbours inside the tile: left and
// up, plus up-left and up-right when 8-connected; together over all pixels
// these cover every edge once.
template <bool CONN8>
static __global__ void uf_local_kernel(const bool* __restrict__ active, int* __restrict__ parent, int H, int W) {
  __shared__ int s[UF_TX * UF_TY];
  const int lx = threadIdx.x, ly = threadIdx.y, l = ly * UF_TX + lx;
  const int x = blockIdx.x * UF_TX + lx, y = blockIdx.y * UF_TY + ly;
  const bool in = x < W && y < H;
  const bool a = in && active[y * W + x];
  s[l] = l;
  __syncthreads();
  if (a) {
    const int i = y * W + x;
    if (lx > 0 && active[i - 1]) suf_union(s, l, l - 1);
    if (ly > 0) {
      if (active[i - W]) suf_union(s, l, l - UF_TX);
      if (CONN8) {
        if (lx > 0 && active[i - W - 1]) suf_union(s, l, l - UF_TX - 1);
        if (lx + 1 < UF_TX && x + 1 < W && active[i - W + 1]) suf_union(s, l, l - UF_TX + 1);
      }
    }
  }
  __syncthreads();
  if (in) {
    const int r = a ? suf_find(s, l) : l;
    parent[y * W + x] = (blockIdx.y * UF_TY + r / UF_TX) * W + blockIdx.x * UF_TX + r % UF_TX;
  }
}

// Level 2: the backward edges that cross a tile border, one thread per pixel.
template <bool CONN8>
static __global__ void uf_border_kernel(const bool* __restrict__ active, int* parent, int H, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W || !active[i]) return;
  const int x = i % W, y = i / W;
  const bool left_edge = x % UF_TX == 0, top_edge = y % UF_TY == 0;
  if (x > 0 && left_edge && active[i - 1]) uf_union(parent, i, i - 1);
  if (y > 0) {
    if (top_edge && active[i - W]) uf_union(parent, i, i - W);
    if (CONN8) {
      if (x > 0 && (left_edge || top_edge) && active[i - W - 1]) uf_union(parent, i, i - W - 1);
      if (x + 1 < W && ((x + 1) % UF_TX == 0 || top_edge) && active[i - W + 1]) uf_union(parent, i, i - W + 1);
    }
  }
}

// Both levels: afterwards uf_find(parent, p) is the minimum index of p's set.
template <bool CONN8>
static inline void uf_build(const bool* active, int* parent, int H, int W, cudaStream_t stream) {
  dim3 tile(UF_TX, UF_TY);
  dim3 tiles((W + UF_TX - 1) / UF_TX, (H + UF_TY - 1) / UF_TY);
  uf_local_kernel<CONN8><<<tiles, tile, 0, stream>>>(active, parent, H, W);
  uf_border_kernel<CONN8><<<tt_blocks(H * W, 256), 256, 0, stream>>>(active, parent, H, W);
}
