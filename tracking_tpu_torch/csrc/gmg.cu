// gmg_step: GMG's per-pixel move-to-front list update, one thread per pixel,
// touching only the slots of the pixel's list.
//
// Replaces tracking_tpu/ops/pallas_gmg.py:gmg_step_pallas. Per pixel, in
// order: find the frame's code among the first nf slots; the matched weight
// w_match; the posterior and the foreground decision (never while
// training); decay every weight by (1 - lr) (not while training); the front
// weight; then one ascending pass that moves the match to the front (slots
// 1..fi take their predecessor), or evicts the last entry of a full list
// (slots 1..K-1 shift), or appends at slot nf, and sums the kept weights;
// last, the normalisation when the list grew after training or training
// ends.
//
// The invariant every GMG state keeps: slots at or past nf hold (-1, +0.0).
// init builds them so, and decay (0 x (1 - lr)), the shift, the append at
// nf and the normalisation (0 / d) all keep it. So the reference's result
// past nf1 (the list's new length) is what the slots hold already, and the
// kernel stops both passes at nf1:
//   - the find reads colours up to the first match, kBatch slots a load batch;
//   - the ascending pass runs over k < nf1 in batches of kBatch slots, every
//     load of a batch before its stores (the update is IN PLACE: slot k's
//     new value needs only the old slots k - 1 and k). It reads the
//     colours that move (k < the last shifted slot) and the weights it needs
//     (those that move, decay or enter `total`), and writes the colours that
//     change (the shifted slots and the append slot) and the weights that
//     change (all k < nf1 outside training; in training only the shifted
//     and appended ones);
//   - `total` adds the new weights in runs of kSumBlock in index order, then
//     the partial sums, as the plain version sums all K terms: the terms
//     past nf1 are +0, and adding +0 to a non-negative sum is exact, so
//     stopping at nf1 gives the same bits;
//   - the normalisation rewrites only k < nf1 (0 / d = +0 past them).
// Slots are planes [K, H, W] with adjacent threads on adjacent pixels, so
// every slot access is coalesced; a warp's loops run to the longest list
// among its lanes, and the lanes past their own list fetch nothing.
//
// Colours are int32 (the sentinel 0xFFFFFFFF is -1). `t` is read from the
// card, so a frame needs no host sync.
//
// Bound on the H100: device-memory bytes, and they depend on the lists:
// code, nf, fg and nf1 (16 B/px), the colours the find examines, the list's
// weights and the slots that change (chip_smoke.py counts them from its
// run's lists; lists average 3.5 slots there). The earlier design read and
// wrote all 64 slots of every pixel, 1 KiB a pixel (0.53 ms at 720p on an
// H100 against a 0.015 ms bound, PERF.md section 6).
#include "common.cuh"

// `total` is summed in XLA:CPU's order for a long reduction: runs of 32
// slots in index order, then the partial sums in order (ops/gmg.py).
constexpr int kSumBlock = 32;
constexpr int kBatch = 2;  // slots loaded before the first is used: 2 beat 4 and 8 on an H100 (PERF.md section 6)

__global__ void gmg_kernel(const int32_t* __restrict__ code_map, const int32_t* __restrict__ nf_map,
                           int32_t* __restrict__ colors, float* __restrict__ weights, const int32_t* __restrict__ t_ptr,
                           int32_t* __restrict__ fg_out, int32_t* __restrict__ nf_out, int K, int H, int W, float lr,
                           float oml, float prior, float omp, float thr, int init_frames) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t HW = (size_t)H * W;
  if (p >= H * W) return;
  const int t = *t_ptr;
  const bool training = t < init_frames;
  const bool end_train = t == init_frames - 1;
  const int code = code_map[p];
  const int nf = nf_map[p];
  int32_t* col = colors + p;
  float* wt = weights + p;

  int fi = K;  // first find
  const int listed = min(nf, K);
  for (int k0 = 0; k0 < listed && fi == K; k0 += kBatch) {
    int c[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) c[i] = k0 + i < listed ? col[(size_t)(k0 + i) * HW] : ~code;
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (fi == K && c[i] == code) fi = k0 + i;
  }
  const bool has = fi < K;
  const float w_fi = has ? wt[(size_t)fi * HW] : 0.0f;
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
  const bool do_norm = (appended && !training) || end_train;
  // slots 0..last take (code, front weight), then their predecessors; -1: none
  const int last = has ? fi : (full ? K - 1 : -1);
  const int app = appended ? nf : -1;  // the append slot
  const int len = min(nf1, K);

  int prev_c = 0;  // slot k - 1's old colour and decayed weight
  float prev_w = 0.0f, total = 0.0f, part = 0.0f;
  for (int k0 = 0; k0 < len; k0 += kBatch) {
    int c_old[kBatch];
    float w_old[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int k = k0 + i;
      // a kept slot's weight is read where it decays or enters total
      const bool need_w = k < last || (k > last && k < nf && (!training || do_norm));
      c_old[i] = k < last ? col[(size_t)k * HW] : 0;
      w_old[i] = need_w ? wt[(size_t)k * HW] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int k = k0 + i;
      if (k < len) {
        const float d_k = training ? w_old[i] : w_old[i] * oml;
        float new_w;
        if (k <= last || k == app) {
          col[(size_t)k * HW] = k == 0 || k == app ? code : prev_c;
          new_w = k == 0 || k == app ? front_w : prev_w;
          wt[(size_t)k * HW] = new_w;
        } else {
          new_w = d_k;
          if (!training) wt[(size_t)k * HW] = new_w;
        }
        part = part + new_w;
        if (k % kSumBlock == kSumBlock - 1) {
          total = total + part;
          part = 0.0f;
        }
        prev_c = c_old[i];
        prev_w = d_k;
      }
    }
  }
  total = total + part;  // + 0.0 when len ends a run: exact

  if (do_norm) {
    const float d = fmaxf(total, 1e-20f);
    for (int k0 = 0; k0 < len; k0 += kBatch) {
      float w[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) w[i] = k0 + i < len ? wt[(size_t)(k0 + i) * HW] : 0.0f;
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (k0 + i < len) wt[(size_t)(k0 + i) * HW] = w[i] / d;
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
