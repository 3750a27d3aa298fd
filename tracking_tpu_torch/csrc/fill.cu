// flood_reach: 4-connected reachability of background pixels from seed
// pixels, the core of SuBSENSE's cv::floodFill hole filling.
//
// Replaces tracking_tpu/ops/pallas_fill.py:flood_reach_pallas, whose TPU
// kernel propagates the seeds in sequential tile-raster passes repeated to a
// fixed point. Here: the two-level union-find of common.cuh over background
// pixels, then every component holding a seed is marked at its root and
// reach = reach0 | (bg & marked[root]). Exact for any mask, with no round
// cap.
//
// Bound on the H100: latency, not bandwidth - the image is 0.9 MB of bools
// and the 3.7 MB parent array stays in the 50 MB L2. Background is most of
// a frame, so one component spans most tiles; a single-level union-find
// (every pixel linking with global atomics) measured slower than the plain
// torch version because of long find walks and contended atomics at the
// big component's root. The tile-local level keeps those in shared memory;
// only tile-border pixels touch global atomics.
#include "common.cuh"

__global__ void fill_mark_kernel(const bool* bg, const bool* reach0, const int* parent, uint8_t* marked, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && bg[i] && reach0[i]) marked[uf_find(parent, i)] = 1;
}

__global__ void fill_out_kernel(const bool* bg, const bool* reach0, const int* parent, const uint8_t* marked,
                                bool* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = reach0[i] || (bg[i] && marked[uf_find(parent, i)] != 0);
}

TT_EXPORT int tt_flood_reach(const void* bg_, const void* reach0_, void* parent_, void* marked_, void* out_,
                             int H, int W, void* stream_) {
  const bool* bg = static_cast<const bool*>(bg_);
  const bool* reach0 = static_cast<const bool*>(reach0_);
  int* parent = static_cast<int*>(parent_);
  uint8_t* marked = static_cast<uint8_t*>(marked_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int n = H * W, threads = 256;
  if (n == 0) return 0;
  uf_build<false>(bg, parent, H, W, stream);
  cudaError_t err = cudaMemsetAsync(marked, 0, (size_t)n, stream);
  if (err != cudaSuccess) return (int)err;
  fill_mark_kernel<<<tt_blocks(n, threads), threads, 0, stream>>>(bg, reach0, parent, marked, n);
  fill_out_kernel<<<tt_blocks(n, threads), threads, 0, stream>>>(bg, reach0, parent, marked,
                                                                 static_cast<bool*>(out_), n);
  return (int)cudaGetLastError();
}

TT_EXPORT const char* tt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
