// multilayer_step: MultiLayerBGS's per-pixel frame update, one thread per
// pixel with the M = 5 modes in a local array.
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
// times f32(1/6), true divisions, expf and sqrtf (IEEE without fast math),
// no fused multiply-adds (-fmad=false). The learning scalars (lr, wlr, imw,
// 1 - lr) and the frame index are read from the card: under detectAfter they
// depend on the frame.
//
// Bound on the H100: device-memory bytes. The state is 448 B per pixel read
// and written once (5 modes x 22 words x 4 B = 440 B, plus n and bg_num),
// with cf, the pattern and the distance: about 936 B per pixel, 862.6 MB at
// 720p, 0.258 ms at 3.35 TB/s. Every leaf plane is read and written
// coalesced across adjacent pixels; the per-pixel work (5 modes, a few
// hundred flops) keeps the kernel near the byte bound only if the local
// array stays out of device memory, which the register count decides.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int M = 5;
constexpr int C = 3;
constexpr int L = 6;
constexpr float kPi = 3.141592653589793f;

struct Mode {
  float w, mw, bi[C], mini[C], maxi[C], bp[L];
  int layer, layt, ft, lt, fq;
};

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

__device__ __forceinline__ int bg_num_of(const Mode* md, int n, float bg_pct) {
  float aw[M];
#pragma unroll
  for (int m = 0; m < M; ++m) aw[m] = n > m ? md[m].w : 0.0f;
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
__global__ void __launch_bounds__(128)
    multilayer_kernel(Leaves s, const float* __restrict__ cf_map, const float* __restrict__ pat_map,
                      const float* __restrict__ scal, const int32_t* __restrict__ fidx_ptr, float* __restrict__ dist_out,
                      int H, int W, Consts k) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= H * W) return;
  const size_t HW = (size_t)H * W;
  const float lr = scal[0], wlr = scal[1], imw = scal[2], oml = scal[3];
  const int fidx = *fidx_ptr;

  Mode md[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const size_t i = (size_t)m * HW + p;
    md[m].w = s.w[i];
    md[m].mw = s.mw[i];
    md[m].layer = s.layer[i];
    md[m].layt = s.layt[i];
    md[m].ft = s.ft[i];
    md[m].lt = s.lt[i];
    md[m].fq = s.fq[i];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t j = ((size_t)m * C + c) * HW + p;
      md[m].bi[c] = s.bi[j];
      md[m].mini[c] = s.mini[j];
      md[m].maxi[c] = s.maxi[j];
    }
#pragma unroll
    for (int l = 0; l < L; ++l) md[m].bp[l] = s.bp[((size_t)m * L + l) * HW + p];
  }
  float cf[C], pat[L];
#pragma unroll
  for (int c = 0; c < C; ++c) cf[c] = cf_map[(size_t)c * HW + p];
#pragma unroll
  for (int l = 0; l < L; ++l) pat[l] = pat_map[(size_t)l * HW + p];
  int n = s.n[p];
  int bg_num = s.bg_num[p];

  // -- RemoveBackgroundLayers, single removal ---------------------------------
  bool changed1 = false;
  if (LEARN) {
    int r = M;
#pragma unroll
    for (int m = M - 1; m >= 0; --m)
      if (md[m].layer > 0 && md[m].w < k.min_layer_w && n > m) r = m;
    changed1 = r < M;
    if (changed1) {
      const int rl = md[r].layer;
      for (int m = r; m < M - 1; ++m) md[m] = md[m + 1];
      if (rl > 0) {
#pragma unroll
        for (int m = 0; m < M; ++m)
          if (md[m].layer > rl) md[m].layer -= 1;
      }
      n -= 1;
      bg_num = bg_num_of(md, n, k.bg_pct);
    }
  }
  const bool is_empty = n == 0;

  // -- distances and the best mode ---------------------------------------------
  const float n2c = cf[0] * cf[0] + cf[1] * cf[1] + cf[2] * cf[2];
  float best_d = INFINITY;
  int best = 0;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float moved = 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l) moved = moved + (fabsf(pat[l] - md[m].bp[l]) > k.lbp_thr ? 1.0f : 0.0f);
    const float tex_d = moved * (1.0f / (float)L);
    bool out_range = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float lo = fminf(md[m].mini[c], md[m].bi[c] * k.shadow - 5.0f);
      const float hi = fmaxf(md[m].maxi[c], md[m].bi[c] * k.highlight + 5.0f);
      out_range = out_range || cf[c] > hi || cf[c] < lo;
    }
    const float* bi = md[m].bi;
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
    const float col_d = out_range ? 1.0f : 1.0f - expf(-100.0f * angle * angle);
    float joint = k.tex_w * tex_d + k.col_w * col_d;
    if (!(n > m)) joint = INFINITY;
    if (joint < best_d) best = m;
    best_d = fminf(best_d, joint);
  }
  const bool updating = best_d < k.upd_thr;
  const bool penal = best >= bg_num && md[best].mw < k.reliable;
  float out_dist = penal ? fmaxf(best_d, k.out_floor) : best_d;
  const bool do_match = LEARN && !is_empty && updating;
  const bool do_nomatch = LEARN && !is_empty && !updating;

  bool displaced[M];
#pragma unroll
  for (int m = 0; m < M; ++m) displaced[m] = false;
  if (do_match) {
    Mode& b = md[best];
    b.ft = max(min(b.ft, fidx), 0);
    b.lt = fidx;
    b.fq += 1;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      b.bi[c] = oml * b.bi[c] + lr * cf[c];
      b.mini[c] = fminf(b.mini[c], cf[c]);
      b.maxi[c] = fmaxf(b.maxi[c], cf[c]);
    }
#pragma unroll
    for (int l = 0; l < L; ++l) b.bp[l] = oml * b.bp[l] + lr * pat[l];
    const float inc = wlr * (1.0f + k.wuc * b.mw);
    b.w = (1.0f - inc) * b.w + inc;
    b.mw = fmaxf(b.w, b.mw);
    const int b_layer = b.layer;
    const float b_w = b.w, b_mw = b.mw;
#pragma unroll
    for (int m = 0; m < M; ++m)
      displaced[m] = b_layer > 0 && b_w > b_mw * 0.2f && md[m].layer > b_layer && md[m].w < md[m].mw * 0.9f && n > m;
    const bool promote = b_layer == 0 && b_mw > k.reliable;
    int max_layer = 0;
#pragma unroll
    for (int m = 0; m < M; ++m) max_layer = max(max_layer, n > m ? md[m].layer : 0);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const bool at = m == best;
      if (at && promote) {
        md[m].layer = max_layer + 1;
        md[m].layt = fidx;
      }
      const float decay = 1.0f - wlr / (1.0f + k.wuc * md[m].mw);
      if (n > m && !at) md[m].w = md[m].w * decay;
    }
  } else if (do_nomatch) {
    const int slot = min(n, M - 1);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float decay = 1.0f - wlr / (1.0f + k.wuc * md[m].mw);
      if (m == slot) {
        md[m].w = imw;
        md[m].mw = imw;
#pragma unroll
        for (int c = 0; c < C; ++c) md[m].bi[c] = md[m].mini[c] = md[m].maxi[c] = cf[c];
#pragma unroll
        for (int l = 0; l < L; ++l) md[m].bp[l] = pat[l];
        md[m].layer = 0;
        md[m].layt = -1;
        md[m].ft = md[m].lt = fidx;
        md[m].fq = 1;
      } else if (n > m) {
        md[m].w = md[m].w * decay;
      }
    }
  } else if (is_empty) {
    Mode& z = md[0];
    z.w = imw;
    z.mw = imw;
#pragma unroll
    for (int c = 0; c < C; ++c) z.bi[c] = z.mini[c] = z.maxi[c] = cf[c];
#pragma unroll
    for (int l = 0; l < L; ++l) z.bp[l] = pat[l];
    z.layer = 0;
    z.ft = z.lt = fidx;
    z.fq = 1;
  }
  if (is_empty) {
    n = 1;
    bg_num = 1;
  } else if (do_nomatch) {
    n = min(n + 1, M);
  }

  // -- displaced-layer removal, weight sort, bg_num ----------------------------
  if (LEARN) {
    bool keep[M];
    int layer_old[M], n_rem = 0;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      keep[m] = !displaced[m] && n > m;
      layer_old[m] = md[m].layer;
      n_rem += displaced[m] ? 1 : 0;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      int dec = 0;
#pragma unroll
      for (int j = 0; j < M; ++j) dec += (displaced[j] && layer_old[j] > 0 && layer_old[m] > layer_old[j]) ? 1 : 0;
      md[m].layer = layer_old[m] - dec;
    }
    if (n_rem > 0) {  // stable compaction: kept source j lands at (#kept <= j) - 1
      int run = 0;
      for (int j = 0; j < M; ++j) {
        if (keep[j]) {
          if (run != j) md[run] = md[j];
          ++run;
        }
      }
    }
    n -= n_rem;
    float key[M];
#pragma unroll
    for (int m = 0; m < M; ++m) key[m] = n > m ? md[m].w : -INFINITY;
#pragma unroll
    for (int rnd = 0; rnd < M; ++rnd) {
#pragma unroll
      for (int i = rnd % 2; i < M - 1; i += 2) {
        if (key[i] < key[i + 1]) {
          const float tk = key[i];
          key[i] = key[i + 1];
          key[i + 1] = tk;
          const Mode tm = md[i];
          md[i] = md[i + 1];
          md[i + 1] = tm;
        }
      }
    }
    const bool gate = (n > 1 && !is_empty) || changed1 || n_rem > 0 || is_empty;
    if (gate) bg_num = bg_num_of(md, n, k.bg_pct);
  }
  if (is_empty) out_dist = 0.0f;

#pragma unroll
  for (int m = 0; m < M; ++m) {
    const size_t i = (size_t)m * HW + p;
    s.w[i] = md[m].w;
    s.mw[i] = md[m].mw;
    s.layer[i] = md[m].layer;
    s.layt[i] = md[m].layt;
    s.ft[i] = md[m].ft;
    s.lt[i] = md[m].lt;
    s.fq[i] = md[m].fq;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t j = ((size_t)m * C + c) * HW + p;
      s.bi[j] = md[m].bi[c];
      s.mini[j] = md[m].mini[c];
      s.maxi[j] = md[m].maxi[c];
    }
#pragma unroll
    for (int l = 0; l < L; ++l) s.bp[((size_t)m * L + l) * HW + p] = md[m].bp[l];
  }
  s.n[p] = n;
  s.bg_num[p] = bg_num;
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
  const unsigned blocks = tt_blocks(H * W, 128);
  if (learn)
    multilayer_kernel<true><<<blocks, 128, 0, stream>>>(s, cfp, pp, sp, fp, dp, H, W, k);
  else
    multilayer_kernel<false><<<blocks, 128, 0, stream>>>(s, cfp, pp, sp, fp, dp, H, W, k);
  return (int)cudaGetLastError();
}
