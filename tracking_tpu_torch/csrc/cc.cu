// Two kernels on one union-find (common.cuh): label_components, and
// label_fixpoint further below.
//
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

// ---------------------------------------------------------------------------
// label_fixpoint: the min-label fixed point from arbitrary initial labels.
// For each foreground pixel, the minimum of lab0 over its connected component
// (inside this image, which is one shard's slab on the row-sharded path);
// `big` on background.
//
// Replaces tracking_tpu/ops/pallas_cc.py:label_fixpoint_pallas, whose TPU
// kernel repeats forward and backward tile-raster min propagation passes
// (_raster_pass) until nothing changes. Here there is no data-dependent
// loop: the union-find of common.cuh groups the foreground, each pixel
// folds its lab0 into its root's entry with atomicMin (an integer minimum
// is order-free, so the atomics are exact), and each pixel reads its root's
// entry back. Four kernel launches and one device copy.
//
// Bound on the H100: device-memory bytes, 9 B/px (fg 1 + lab0 4 + labels 4;
// the parent array stays in L2 at a shard's 0.9 MB), and the latency of the
// find walks, as for label_components.

// out holds lab0 on entry; only roots' entries are updated.
__global__ void fixpoint_min_kernel(const bool* fg, const int* parent, const int* lab0, int* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !fg[i]) return;
  const int r = uf_find(parent, i);
  if (r != i) atomicMin(out + r, lab0[i]);
}

// Each pixel writes only its own entry and reads only its root's. A root's
// thread writes back the value it reads, and background pixels are roots of
// no foreground pixel, so no thread reads an entry another thread changes.
__global__ void fixpoint_final_kernel(const bool* fg, const int* parent, int* out, int n, int big) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = fg[i] ? out[uf_find(parent, i)] : big;
}

TT_EXPORT int tt_label_fixpoint(const void* fg_, const void* lab0_, void* parent_, void* out_, int H, int W,
                                int connectivity, int big, void* stream_) {
  const bool* fg = static_cast<const bool*>(fg_);
  const int* lab0 = static_cast<const int*>(lab0_);
  int* parent = static_cast<int*>(parent_);
  int* out = static_cast<int*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int n = H * W, threads = 256;
  if (n == 0) return 0;
  cudaError_t err = cudaMemcpyAsync(out, lab0, sizeof(int) * (size_t)n, cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  if (connectivity == 8) {
    uf_build<true>(fg, parent, H, W, stream);
  } else {
    uf_build<false>(fg, parent, H, W, stream);
  }
  fixpoint_min_kernel<<<tt_blocks(n, threads), threads, 0, stream>>>(fg, parent, lab0, out, n);
  fixpoint_final_kernel<<<tt_blocks(n, threads), threads, 0, stream>>>(fg, parent, out, n, big);
  return (int)cudaGetLastError();
}
