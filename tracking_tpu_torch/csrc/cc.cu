// label_components: connected components of a binary mask, 8- or
// 4-connected. A label is the component's minimum row-major pixel index;
// background is -1.
//
// Replaces tracking_tpu/ops/pallas_cc.py:label_components_pallas, whose TPU
// kernel runs sequential tile-raster min-label propagation to a fixed point.
// Here: the two-level union-find of common.cuh over foreground pixels,
// written into the output buffer itself; since every link points to the
// smaller index, the final find gives exactly the reference's labels.
//
// Bound on the H100: latency of the find walks and atomics over a 3.7 MB
// label array that stays in L2. SuBSENSE's masks are mostly background, so
// most threads exit at once; the tile-local level keeps the foreground
// links in shared memory and leaves global atomics to tile-border pixels.
#include "common.cuh"

// Foreground chains pass only through foreground pixels, so writing -1 to
// background pixels and roots to foreground pixels while other threads walk
// is safe: a pixel's entry only ever moves to one of its ancestors.
__global__ void cc_final_kernel(const bool* fg, int* lab, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  lab[i] = fg[i] ? uf_find(lab, i) : -1;
}

TT_EXPORT int tt_label_components(const void* fg_, void* out_, int H, int W, int connectivity, void* stream_) {
  const bool* fg = static_cast<const bool*>(fg_);
  int* lab = static_cast<int*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int n = H * W, threads = 256;
  if (n == 0) return 0;
  if (connectivity == 8) {
    uf_build<true>(fg, lab, H, W, stream);
  } else {
    uf_build<false>(fg, lab, H, W, stream);
  }
  cc_final_kernel<<<tt_blocks(n, threads), threads, 0, stream>>>(fg, lab, n);
  return (int)cudaGetLastError();
}
