// gmg_step: GMG's per-pixel move-to-front list update, one thread per pixel,
// looping over the K = 64 slots in index order.
//
// Replaces tracking_tpu/ops/pallas_gmg.py:gmg_step_pallas. Per pixel, in
// order: find the frame's code among the first nf slots; the matched weight
// w_match; the posterior and the foreground decision (never while
// training); decay every weight by (1 - lr) (not while training); the front
// weight; then one ascending pass that moves the match to the front (slots
// 1..fi take their predecessor), or evicts the last entry of a full list
// (slots 1..K-1 shift), or appends at slot nf, and sums the kept weights;
// last, the normalisation when the list grew after training
// or training ends. The ascending pass updates the banks IN PLACE: it reads
// slot k before writing it and carries slot k-1's old colour and decayed
// weight in registers.
//
// Colours are int32 (the sentinel 0xFFFFFFFF is -1). `t` is read from the
// card, so a frame needs no host sync. The sum `total` takes the plain
// version's order, so both agree exactly.
//
// Bound on the H100: device-memory bytes, and they depend on the lists.
// Slots at or past a pixel's list length nf hold (-1, 0) and never change,
// so the update needs only the list's slots: the colours the find reads,
// the list's weights, and the slots that change (chip_smoke.py computes
// this from its run's lists). This kernel still reads and writes all 64
// slots of every pixel, 1 KiB per pixel whatever nf is; stopping both loops
// at nf1 is the next step. Adjacent threads take adjacent pixels of one
// slot plane, so every slot load and store is coalesced; the normalisation
// pass re-reads a pixel's weights only on the frames that normalise it.
#include "common.cuh"

// `total` is summed in XLA:CPU's order for a long reduction: runs of 32
// slots in index order, then the partial sums in order (ops/gmg.py).
constexpr int kSumBlock = 32;

__global__ void gmg_kernel(const int32_t* __restrict__ code_map, const int32_t* __restrict__ nf_map, int32_t* colors,
                           float* weights, const int32_t* __restrict__ t_ptr, int32_t* __restrict__ fg_out,
                           int32_t* __restrict__ nf_out, int K, int H, int W, float lr, float oml, float prior,
                           float omp, float thr, int init_frames) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t HW = (size_t)H * W;
  if (p >= H * W) return;
  const int t = *t_ptr;
  const bool training = t < init_frames;
  const bool end_train = t == init_frames - 1;
  const int code = code_map[p];
  const int nf = nf_map[p];

  int fi = K;  // first find
  for (int k = 0; k < K && k < nf; ++k) {
    if (colors[(size_t)k * HW + p] == code) {
      fi = k;
      break;
    }
  }
  const bool has = fi < K;
  const float w_fi = has ? weights[(size_t)fi * HW + p] : 0.0f;
  const float w_match = has ? w_fi : 0.0f;
  const float post = (w_match * prior) / (w_match * prior + (1.0f - w_match) * omp);
  const bool is_fg = !training && (1.0f - post) > thr;
  fg_out[p] = is_fg ? 255 : 0;

  const float insert_w = training ? 1.0f : lr;
  const float front_w = insert_w + (has ? (training ? w_fi : w_fi * oml) : 0.0f);
  const bool full = nf >= K;
  const bool appended = !(has || full);
  const int nf1 = nf + (appended ? 1 : 0);
  nf_out[p] = nf1;

  int prev_c = 0;
  float prev_w = 0.0f, total = 0.0f, part = 0.0f;
  for (int k = 0; k < K; ++k) {
    const size_t i = (size_t)k * HW + p;
    const int c_k = colors[i];
    const float w_k = weights[i];
    const float d_k = training ? w_k : w_k * oml;
    bool shift;
    int new_c;
    float new_w;
    if (k == 0) {
      shift = !appended;
      new_c = code;
      new_w = front_w;
    } else {
      shift = (has && k <= fi) || (!has && full);
      new_c = prev_c;
      new_w = prev_w;
    }
    if (!shift) {
      new_c = c_k;
      new_w = d_k;
    }
    if (appended && k == nf) {
      new_c = code;
      new_w = front_w;
    }
    colors[i] = new_c;
    weights[i] = new_w;
    part = part + (k < nf1 ? new_w : 0.0f);
    if (k % kSumBlock == kSumBlock - 1 || k == K - 1) {
      total = total + part;
      part = 0.0f;
    }
    prev_c = c_k;
    prev_w = d_k;
  }

  if ((appended && !training) || end_train) {
    const float d = fmaxf(total, 1e-20f);
    for (int k = 0; k < K; ++k) {
      const size_t i = (size_t)k * HW + p;
      weights[i] = weights[i] / d;
    }
  }
}

TT_EXPORT int tt_gmg_step(const void* code, const void* nf, void* colors, void* weights, const void* t, void* fg,
                          void* nf1, int K, int H, int W, float lr, float oml, float prior, float omp, float thr,
                          int init_frames, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  gmg_kernel<<<tt_blocks(H * W, 256), 256, 0, stream>>>(
      static_cast<const int32_t*>(code), static_cast<const int32_t*>(nf), static_cast<int32_t*>(colors),
      static_cast<float*>(weights), static_cast<const int32_t*>(t), static_cast<int32_t*>(fg),
      static_cast<int32_t*>(nf1), K, H, W, lr, oml, prior, omp, thr, init_frames);
  return (int)cudaGetLastError();
}
