// multilayer_step: MultiLayerBGS's per-pixel frame update, one thread per
// pixel, the M = 5 modes of a block's pixels in shared memory.
//
// Replaces tracking_tpu/ops/pallas_multilayer.py:multilayer_step_pallas,
// whose body is tracking_tpu/bgs/multilayer.py:_ml_update; this kernel runs
// that function statement by statement for one pixel: the single-layer
// removal, the per-mode texture and colour distances, the best mode, one of
// the three branches (match: blend the best mode, layer bookkeeping, decay
// the others; no match: decay and append or overwrite the tail; empty:
// seed), the displaced-layer removal, the strict-< odd-even weight sort and
// bg_num. The state is updated IN PLACE: a thread reads and writes only its
// own pixel.
//
// Floats follow the plain version (ops/multilayer.py:ml_update_ref) op for
// op: sums over the colour axis in index order, the pattern mean as a sum
// times f32(1/6), true divisions, no fused multiply-adds (-fmad=false) but
// those of XLA:CPU's exp (common.cuh's xla_expf, as the plain version's
// xla_math.exp), and sqrtf, which without fast math is IEEE's correctly
// rounded root, as xla_math.sqrt is. The learning scalars (lr, wlr, imw,
// 1 - lr) and the frame index are read from the card: under detectAfter they
// depend on the frame.
//
// Bound on the H100: device-memory bytes. The whole state is 448 B a pixel
// (5 modes x 22 words x 4 B, plus n and bg_num); read and written once with
// cf, the pattern and the distance that is 936 B a pixel, 862.6 MB and
// 0.258 ms at 720p and 3.35 TB/s. The data needs less, and the kernel moves
// only that (chip_smoke.py's multilayer_cost counts it: about 190 B a pixel
// on its 720p state, mean n 1.23):
//   - it copies the live modes (m < n on entry) into shared memory, and a
//     tail mode (m >= n) only on a pixel whose removal shifts the tail down
//     (all its words) or whose displaced-layer removal renumbers its layer
//     (the layer word);
//   - it writes a word only where its value changes: a mode carries the
//     slot it was read from and a bit for each word changed in place; a
//     mode that moved to another slot, or was seeded, is written whole; n
//     and bg_num only where they change.
// That rests on the tail-mode invariant of _ml_update, which
// tests/test_torch_multilayer_kernel.py holds on ml_update_ref: on a pixel
// with no removal and no displacement, every word of a slot m >= n on entry
// comes out unchanged, except the slot the no-match or empty seed writes
// (the no-match seed writes all 22 words; the empty seed all but layt,
// which therefore stays in memory unread). The sort never moves a tail
// mode: its key is -inf and a swap needs a strict <.
// The update indexes modes at run time (the removal shift, the best mode,
// the compaction). In a local array that is a 440-byte stack frame; in
// registers with static indices only it takes 217 registers, 2 blocks of
// 128 threads an SM, too few warps to hide the loads. Here a thread's
// modes live in shared memory, word w of slot m at (m * 24 + w) * 64 words
// from the thread's own column (22 words, the source slot, the dirty bits):
// a warp's accesses hit 32 banks whatever slot each thread indexes. The
// loads are 4-byte cp.async copies that hold no registers while in flight;
// each thread waits only for its own. ptxas (CUDA 12.8, sm_90a):
// multilayer_kernel<1> 64 registers, <0> 48, no stack frame, no spills
// (chip_smoke.py phase 2 fails on either), 30,720 B of dynamic shared
// memory a block of 64 threads: 7 blocks, 14 warps an SM. Blocks of 32 or
// 128 threads were slower.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int M = 5;
constexpr int C = 3;
constexpr int L = 6;
constexpr float kPi = 3.141592653589793f;
constexpr int kT = 64;  // threads (pixels) a block

// a mode's words in shared memory, in this order; bit w of a mode's dirty
// word marks word w changed in place
constexpr int kW = 0, kMW = 1, kBI = 2, kMINI = 5, kMAXI = 8, kBP = 11, kLAYER = 17, kLAYT = 18, kFT = 19,
              kLT = 20, kFQ = 21, kNW = 22;
constexpr int kSrc = kNW, kDirty = kNW + 1, kNS = kNW + 2;  // + the source slot, the dirty bits
constexpr unsigned kALL = (1u << kNW) - 1u;
constexpr int kSmemBytes = M * kNS * kT * 4;

// Config constants; the derived ones are formed in double on the host, as
// the reference's Python forms them.
struct Consts {
  float wuc, bg_pct, min_layer_w, lbp_thr, offset, min_sine, min_angle, shadow, highlight, tex_w, col_w, upd_thr,
      out_floor, reliable;
};

struct Leaves {
  int32_t* n;
  int32_t* bg_num;
  float *w, *mw, *bi, *mini, *maxi, *bp;
  int32_t *layer, *layt, *ft, *lt, *fq;
};

// Pixel p's word w of slot m in device memory.
__device__ __forceinline__ uint32_t* gword(const Leaves& s, int m, int w, size_t HW, int p) {
  void* a;
  if (w == kW) a = s.w + (size_t)m * HW;
  else if (w == kMW) a = s.mw + (size_t)m * HW;
  else if (w < kMINI) a = s.bi + ((size_t)m * C + (w - kBI)) * HW;
  else if (w < kMAXI) a = s.mini + ((size_t)m * C + (w - kMINI)) * HW;
  else if (w < kBP) a = s.maxi + ((size_t)m * C + (w - kMAXI)) * HW;
  else if (w < kLAYER) a = s.bp + ((size_t)m * L + (w - kBP)) * HW;
  else if (w == kLAYER) a = s.layer + (size_t)m * HW;
  else if (w == kLAYT) a = s.layt + (size_t)m * HW;
  else if (w == kFT) a = s.ft + (size_t)m * HW;
  else if (w == kLT) a = s.lt + (size_t)m * HW;
  else a = s.fq + (size_t)m * HW;
  return static_cast<uint32_t*>(a) + p;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// A thread's modes in shared memory: word w of slot m at (m * kNS + w) * kT
// words from the thread's own column, so a warp's accesses hit 32 banks
// whatever slot each thread indexes.
struct Modes {
  uint32_t* b;
  __device__ __forceinline__ uint32_t& at(int m, int w) const { return b[(m * kNS + w) * kT]; }
  __device__ __forceinline__ float f(int m, int w) const { return __uint_as_float(at(m, w)); }
  __device__ __forceinline__ int i(int m, int w) const { return (int)at(m, w); }
  __device__ __forceinline__ void put(int m, int w, uint32_t u) const {
    if (u != at(m, w)) at(m, kDirty) |= 1u << w;
    at(m, w) = u;
  }
  __device__ __forceinline__ void setf(int m, int w, float v) const { put(m, w, __float_as_uint(v)); }
  __device__ __forceinline__ void seti(int m, int w, int v) const { put(m, w, (uint32_t)v); }
  __device__ __forceinline__ void copy(int d, int from) const {
#pragma unroll
    for (int w = 0; w < kNS; ++w) at(d, w) = at(from, w);
  }
  __device__ __forceinline__ void swap(int a, int c) const {
#pragma unroll
    for (int w = 0; w < kNS; ++w) {
      const uint32_t t = at(a, w);
      at(a, w) = at(c, w);
      at(c, w) = t;
    }
  }
  // slot m's words from device memory (LEARN = false: those the distances
  // and `penal` read)
  template <bool LEARN>
  __device__ __forceinline__ void load(const Leaves& s, int m, size_t HW, int p) const {
#pragma unroll
    for (int w = 0; w < kNW; ++w)
      if (LEARN || w == kMW || (w >= kBI && w < kLAYER)) cp_async4(&at(m, w), gword(s, m, w, HW, p));
  }
  // a mode seeded from the frame (every word but layt; layer 0)
  __device__ __forceinline__ void seed(int m, float imw, const float* cf, const float* pat, int fidx) const {
    at(m, kW) = at(m, kMW) = __float_as_uint(imw);
#pragma unroll
    for (int c = 0; c < C; ++c) at(m, kBI + c) = at(m, kMINI + c) = at(m, kMAXI + c) = __float_as_uint(cf[c]);
#pragma unroll
    for (int l = 0; l < L; ++l) at(m, kBP + l) = __float_as_uint(pat[l]);
    at(m, kLAYER) = 0u;
    at(m, kFT) = at(m, kLT) = (uint32_t)fidx;
    at(m, kFQ) = 1u;
  }
};

// One compare-exchange of the odd-even sort (static slots I, I + 1).
template <int I>
__device__ __forceinline__ void sort_step(float* key, const Modes& md) {
  if (key[I] < key[I + 1]) {
    const float t = key[I];
    key[I] = key[I + 1];
    key[I + 1] = t;
    md.swap(I, I + 1);
  }
}

__device__ __forceinline__ int bg_num_of(const Modes& md, int n, float bg_pct) {
  float aw[M];
#pragma unroll
  for (int m = 0; m < M; ++m) aw[m] = n > m ? md.f(m, kW) : 0.0f;
  float tot = aw[0];
#pragma unroll
  for (int m = 1; m < M; ++m) tot = tot + aw[m];
  float cum = 0.0f;
  int out = 0;
  bool found = false;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    cum = cum + aw[m];
    const bool over = cum > bg_pct * tot;
    if (!found && over) out = m + 1;
    found = found || over;
  }
  return out;
}

template <bool LEARN>
__global__ void __launch_bounds__(kT)
    multilayer_kernel(Leaves s, const float* __restrict__ cf_map, const float* __restrict__ pat_map,
                      const float* __restrict__ scal, const int32_t* __restrict__ fidx_ptr, float* __restrict__ dist_out,
                      int H, int W, Consts k) {
  extern __shared__ uint32_t smem_modes[];
  const int p = blockIdx.x * kT + threadIdx.x;
  if (p >= H * W) return;
  const size_t HW = (size_t)H * W;
  const Modes md{smem_modes + threadIdx.x};
  const int n_in = s.n[p];
  const int bg_in = s.bg_num[p];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    md.at(m, kSrc) = (uint32_t)m;
    md.at(m, kDirty) = 0u;
    if (m < n_in) md.load<LEARN>(s, m, HW, p);
  }
  const float lr = scal[0], wlr = scal[1], imw = scal[2], oml = scal[3];
  const int fidx = *fidx_ptr;
  float cf[C], pat[L];
#pragma unroll
  for (int c = 0; c < C; ++c) cf[c] = cf_map[(size_t)c * HW + p];
#pragma unroll
  for (int l = 0; l < L; ++l) pat[l] = pat_map[(size_t)l * HW + p];
  int n = n_in;
  int bg_num = bg_in;
  cp_async_wait_all();

  // -- RemoveBackgroundLayers, single removal ---------------------------------
  bool changed1 = false;
  if (LEARN) {
    int r = M;
    for (int m = M - 1; m >= 0; --m)
      if (n > m && md.i(m, kLAYER) > 0 && md.f(m, kW) < k.min_layer_w) r = m;
    changed1 = r < M;
    if (changed1) {  // the shift moves the tail down: read it
      for (int m = n; m < M; ++m) md.load<true>(s, m, HW, p);
      cp_async_wait_all();
      const int rl = md.i(r, kLAYER);
      for (int m = r; m < M - 1; ++m) md.copy(m, m + 1);
      if (rl > 0)
        for (int m = 0; m < M; ++m)
          if (md.i(m, kLAYER) > rl) md.seti(m, kLAYER, md.i(m, kLAYER) - 1);
      n -= 1;
      bg_num = bg_num_of(md, n, k.bg_pct);
    }
  }
  const bool is_empty = n == 0;

  // -- distances and the best mode ---------------------------------------------
  const float n2c = cf[0] * cf[0] + cf[1] * cf[1] + cf[2] * cf[2];
  float best_d = INFINITY;
  int best = 0;
  for (int m = 0; m < n; ++m) {  // an inactive mode's distance is +inf
    float moved = 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l) moved = moved + (fabsf(pat[l] - md.f(m, kBP + l)) > k.lbp_thr ? 1.0f : 0.0f);
    const float tex_d = moved * (1.0f / (float)L);
    bool out_range = false;
    float bi[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      bi[c] = md.f(m, kBI + c);
      const float lo = fminf(md.f(m, kMINI + c), bi[c] * k.shadow - 5.0f);
      const float hi = fmaxf(md.f(m, kMAXI + c), bi[c] * k.highlight + 5.0f);
      out_range = out_range || cf[c] > hi || cf[c] < lo;
    }
    const float dot = bi[0] * cf[0] + bi[1] * cf[1] + bi[2] * cf[2];
    const float n1 = bi[0] * bi[0] + bi[1] * bi[1] + bi[2] * bi[2];
    const float n12 = n1 * n2c;
    const float sin2 = fmaxf(1.0f - dot * dot / fmaxf(n12, 1e-20f), 0.0f);
    const float org_angle = n12 == 0.0f ? 0.0f : sqrtf(sin2);
    const float norm_bg = sqrtf(n1);
    const float sin_noise = k.offset / fmaxf(norm_bg, 1e-20f);
    const float noised = norm_bg == 0.0f ? kPi
                                         : (sin_noise < k.min_sine ? k.min_angle : (sin_noise >= 1.0f ? kPi : sin_noise));
    const float angle = fmaxf(org_angle - noised, 0.0f);
    const float col_d = out_range ? 1.0f : 1.0f - xla_expf(-100.0f * angle * angle);
    const float joint = k.tex_w * tex_d + k.col_w * col_d;
    if (joint < best_d) best = m;
    best_d = fminf(best_d, joint);
  }
  const bool updating = best_d < k.upd_thr;
  const bool penal = best >= bg_num && md.f(best, kMW) < k.reliable;
  float out_dist = penal ? fmaxf(best_d, k.out_floor) : best_d;
  const bool do_match = LEARN && !is_empty && updating;
  const bool do_nomatch = LEARN && !is_empty && !updating;

  bool displaced[M];
#pragma unroll
  for (int m = 0; m < M; ++m) displaced[m] = false;
  if (do_match) {
    const int b = best;
    md.seti(b, kFT, max(min(md.i(b, kFT), fidx), 0));
    md.seti(b, kLT, fidx);
    md.seti(b, kFQ, md.i(b, kFQ) + 1);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      md.setf(b, kBI + c, oml * md.f(b, kBI + c) + lr * cf[c]);
      md.setf(b, kMINI + c, fminf(md.f(b, kMINI + c), cf[c]));
      md.setf(b, kMAXI + c, fmaxf(md.f(b, kMAXI + c), cf[c]));
    }
#pragma unroll
    for (int l = 0; l < L; ++l) md.setf(b, kBP + l, oml * md.f(b, kBP + l) + lr * pat[l]);
    const float b_mw0 = md.f(b, kMW);
    const float inc = wlr * (1.0f + k.wuc * b_mw0);
    const float b_w = (1.0f - inc) * md.f(b, kW) + inc;
    md.setf(b, kW, b_w);
    const float b_mw = fmaxf(b_w, b_mw0);
    md.setf(b, kMW, b_mw);
    const int b_layer = md.i(b, kLAYER);
#pragma unroll
    for (int m = 0; m < M; ++m)
      displaced[m] = n > m && b_layer > 0 && b_w > b_mw * 0.2f && md.i(m, kLAYER) > b_layer &&
                     md.f(m, kW) < md.f(m, kMW) * 0.9f;
    const bool promote = b_layer == 0 && b_mw > k.reliable;
    int max_layer = 0;
#pragma unroll
    for (int m = 0; m < M; ++m) max_layer = max(max_layer, n > m ? md.i(m, kLAYER) : 0);
    if (promote) {
      md.seti(b, kLAYER, max_layer + 1);
      md.seti(b, kLAYT, fidx);
    }
    for (int m = 0; m < n; ++m)
      if (m != b) md.setf(m, kW, md.f(m, kW) * (1.0f - wlr / (1.0f + k.wuc * md.f(m, kMW))));
  } else if (do_nomatch) {
    const int slot = min(n, M - 1);
    for (int m = 0; m < n; ++m)
      if (m != slot) md.setf(m, kW, md.f(m, kW) * (1.0f - wlr / (1.0f + k.wuc * md.f(m, kMW))));
    md.seed(slot, imw, cf, pat, fidx);
    md.at(slot, kLAYT) = (uint32_t)-1;
    md.at(slot, kSrc) = (uint32_t)-1;
  } else if (is_empty) {
    // slot 0 keeps its layt: unread (a tail slot) unless a removal moved a
    // mode there, and then written with the rest of that mode
    md.seed(0, imw, cf, pat, fidx);
    md.at(0, kDirty) = kALL & ~(1u << kLAYT);
  }
  if (is_empty) {
    n = 1;
    bg_num = 1;
  } else if (do_nomatch) {
    n = min(n + 1, M);
  }

  // -- displaced-layer removal, weight sort, bg_num ----------------------------
  if (LEARN) {
    int n_rem = 0;
#pragma unroll
    for (int m = 0; m < M; ++m) n_rem += displaced[m] ? 1 : 0;
    if (n_rem > 0) {
      if (!changed1)  // the renumbering reaches the tail's layers: read them
        for (int m = n; m < M; ++m) md.at(m, kLAYER) = *gword(s, m, kLAYER, HW, p);
      int layer_old[M];
#pragma unroll
      for (int m = 0; m < M; ++m) layer_old[m] = md.i(m, kLAYER);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        int dec = 0;
#pragma unroll
        for (int j = 0; j < M; ++j) dec += (displaced[j] && layer_old[j] > 0 && layer_old[m] > layer_old[j]) ? 1 : 0;
        md.seti(m, kLAYER, layer_old[m] - dec);
      }
      int run = 0;  // stable compaction: kept source j lands at (#kept <= j) - 1
#pragma unroll
      for (int j = 0; j < M; ++j) {
        if (!displaced[j] && n > j) {
          if (run != j) md.copy(run, j);
          ++run;
        }
      }
      n -= n_rem;
    }
    float key[M];
#pragma unroll
    for (int m = 0; m < M; ++m) key[m] = n > m ? md.f(m, kW) : -INFINITY;
#pragma unroll
    for (int rnd = 0; rnd < M; ++rnd) {
      if (rnd % 2 == 0) {
        sort_step<0>(key, md);
        sort_step<2>(key, md);
      } else {
        sort_step<1>(key, md);
        sort_step<3>(key, md);
      }
    }
    const bool gate = (n > 1 && !is_empty) || changed1 || n_rem > 0 || is_empty;
    if (gate) bg_num = bg_num_of(md, n, k.bg_pct);
  }
  if (is_empty) out_dist = 0.0f;

  // -- write back the words that changed -------------------------------------
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const unsigned wr = md.i(m, kSrc) == m ? md.at(m, kDirty) : kALL;
    if (wr == 0u) continue;
#pragma unroll
    for (int w = 0; w < kNW; ++w)
      if (wr & (1u << w)) *gword(s, m, w, HW, p) = md.at(m, w);
  }
  if (n != n_in) s.n[p] = n;
  if (bg_num != bg_in) s.bg_num[p] = bg_num;
  dist_out[p] = out_dist;
}

}  // namespace

TT_EXPORT int tt_multilayer_step(void* n, void* bg_num, void* w, void* mw, void* bi, void* mini, void* maxi, void* bp,
                                 void* layer, void* layt, void* ft, void* lt, void* fq, const void* cf,
                                 const void* pat, const void* scal, const void* frame_idx, void* dist, int H, int W,
                                 int learn, float wuc, float bg_pct, float min_layer_w, float lbp_thr, float offset,
                                 float min_sine, float min_angle, float shadow, float highlight, float tex_w,
                                 float col_w, float upd_thr, float out_floor, float reliable, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  Leaves s;
  s.n = static_cast<int32_t*>(n);
  s.bg_num = static_cast<int32_t*>(bg_num);
  s.w = static_cast<float*>(w);
  s.mw = static_cast<float*>(mw);
  s.bi = static_cast<float*>(bi);
  s.mini = static_cast<float*>(mini);
  s.maxi = static_cast<float*>(maxi);
  s.bp = static_cast<float*>(bp);
  s.layer = static_cast<int32_t*>(layer);
  s.layt = static_cast<int32_t*>(layt);
  s.ft = static_cast<int32_t*>(ft);
  s.lt = static_cast<int32_t*>(lt);
  s.fq = static_cast<int32_t*>(fq);
  const Consts k{wuc,       bg_pct, min_layer_w, lbp_thr, offset,  min_sine,  min_angle,
                 shadow,    highlight, tex_w,    col_w,   upd_thr, out_floor, reliable};
  const float* cfp = static_cast<const float*>(cf);
  const float* pp = static_cast<const float*>(pat);
  const float* sp = static_cast<const float*>(scal);
  const int32_t* fp = static_cast<const int32_t*>(frame_idx);
  float* dp = static_cast<float*>(dist);
  const unsigned blocks = tt_blocks(H * W, kT);
  if (learn)
    multilayer_kernel<true><<<blocks, kT, kSmemBytes, stream>>>(s, cfp, pp, sp, fp, dp, H, W, k);
  else
    multilayer_kernel<false><<<blocks, kT, kSmemBytes, stream>>>(s, cfp, pp, sp, fp, dp, H, W, k);
  return (int)cudaGetLastError();
}
