// fgd_tables: FGD's Bayes-table phase, one thread per pixel.
//
// Replaces tracking_tpu/ops/pallas_fgd.py:fgd_tables_pallas, which streams
// every leaf of both tables through VMEM tiles. Here a pixel touches only
// the table it consults: the colour table (N2c entries of C key bytes)
// where it did not change, the co-occurrence table (N2cc entries of 2C
// bytes) where it did. That is exact: the verdict reads only that table,
// each table is updated only where it is consulted (the colour table also
// on the first frame, when nothing has changed), so the other table's
// leaves are neither read nor written.
//
// Per consulted table, in entry order: the first entry with P > 0 whose key
// equals the pixel's (its key bytes are compared only until a match), and
// the first entry of least P (strict <); then, for a match, its rank (the
// entries of larger P, or of equal P and lower index) and the verdict
// rank < N1 && 2*Pb > T*P; then the decay of every entry, the
// reinforcement of the match or the replacement of the least-P entry, whose
// key bytes alone are written. fg_age and the tables are updated IN PLACE;
// is_bg and lab_bg are new maps. `first` (t == 0) is read on the card.
//
// Float behaviour is the reference's: statistics are loaded as f32,
// computed in f32 (the build has -fmad=false, so a*b+c is a product and a
// sum), and stored once with round to nearest even; the constants T,
// 1 - alpha2 and alpha2 are Python doubles rounded once to f32.
//
// Bound on the H100: device-memory bytes. A colour-table pixel must read
// its 25 x 3 key bytes and 25 P/Pb pairs and write the pairs and one key;
// a co-occurrence pixel the same over 40 entries of 6 bytes; every pixel
// its keys, `changed`, fg_age and the two masks (chip_smoke.py weights the
// two kinds by the run's share of changed pixels). Neighbouring threads take
// neighbouring pixels of one mode-major plane, so every load and store is
// coalesced without a re-layout; the re-reads of P for the rank and the
// update hit the caches.
#include <cuda_fp16.h>

#include "common.cuh"

__device__ __forceinline__ float ld_stat(const float* a, size_t i) { return a[i]; }
__device__ __forceinline__ float ld_stat(const __half* a, size_t i) { return __half2float(a[i]); }
__device__ __forceinline__ void st_stat(float* a, size_t i, float v) { a[i] = v; }
__device__ __forceinline__ void st_stat(__half* a, size_t i, float v) { a[i] = __float2half_rn(v); }

struct Lookup {
  int fi;  // the first match, -1 if none
  int min_idx;  // the first entry of least P
  bool bg;  // the table's verdict (false without a match)
};

// A pixel's key is packed into one register, byte c at bits 8c..8c+7.
template <typename S>
__device__ Lookup lookup(const uint8_t* __restrict__ keys, const S* P, const S* Pb, uint64_t key, int N, int Ck,
                         size_t HW, size_t p, int n1, float T) {
  int fi = -1, mi = 0;
  float pm = 0.0f, minv = 0.0f;
  for (int n = 0; n < N; ++n) {
    const float pn = ld_stat(P, (size_t)n * HW + p);
    if (n == 0 || pn < minv) {
      minv = pn;
      mi = n;
    }
    if (fi < 0 && pn > 0.0f) {
      bool eq = true;
      for (int c = 0; c < Ck && eq; ++c) eq = keys[((size_t)n * Ck + c) * HW + p] == ((key >> (8 * c)) & 0xFF);
      if (eq) {
        fi = n;
        pm = pn;
      }
    }
  }
  bool bg = false;
  if (fi >= 0) {
    const float pbm = ld_stat(Pb, (size_t)fi * HW + p);
    int rank = 0;
    for (int n = 0; n < N; ++n) {
      const float pn = ld_stat(P, (size_t)n * HW + p);
      rank += (pn > pm || (pn == pm && n < fi)) ? 1 : 0;
    }
    const float lhs = 2.0f * pbm;
    const float rhs = T * pm;
    bg = rank < n1 && lhs > rhs;
  }
  return {fi, mi, bg};
}

template <typename S>
__device__ void update(uint8_t* keys, S* P, S* Pb, uint64_t key, const Lookup& L, int N, int Ck, size_t HW,
                       size_t p, float lab, float oma, float alpha) {
  const bool has = L.fi >= 0;
  const int at = has ? L.fi : L.min_idx;
  const float a_lab = alpha * lab;
  for (int n = 0; n < N; ++n) {
    const size_t i = (size_t)n * HW + p;
    const float p_dec = ld_stat(P, i) * oma;
    const float pb_dec = ld_stat(Pb, i) * oma;
    if (n == at) {
      st_stat(P, i, has ? p_dec + alpha : alpha);
      st_stat(Pb, i, has ? pb_dec + a_lab : a_lab);
    } else {
      st_stat(P, i, p_dec);
      st_stat(Pb, i, pb_dec);
    }
  }
  if (!has) {
    for (int c = 0; c < Ck; ++c) keys[((size_t)at * Ck + c) * HW + p] = (uint8_t)((key >> (8 * c)) & 0xFF);
  }
}

template <typename S>
__global__ void fgd_tables_kernel(uint8_t* ct_key, S* ct_P, S* ct_Pb, uint8_t* cc_key, S* cc_P, S* cc_Pb,
                                  int32_t* __restrict__ fg_age, const uint8_t* __restrict__ ckey,
                                  const uint8_t* __restrict__ cckey, const bool* __restrict__ changed,
                                  const bool* __restrict__ first_ptr, bool* __restrict__ is_bg_out,
                                  bool* __restrict__ lab_bg_out, int H, int W, int C, int n2c, int n2cc, int n1c,
                                  int n1cc, int absorb, float T, float oma, float alpha) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t HW = (size_t)H * W;
  if (p >= H * W) return;
  const bool first = *first_ptr;
  const bool chg = changed[p];
  const bool do_ct = !chg || first;
  const bool do_cc = chg;
  uint64_t kc = 0, kcc = 0;
  for (int c = 0; c < C; ++c) kc |= (uint64_t)ckey[c * HW + p] << (8 * c);
  for (int c = 0; c < 2 * C; ++c) kcc |= (uint64_t)cckey[c * HW + p] << (8 * c);

  Lookup lct{-1, 0, false}, lcc{-1, 0, false};
  if (do_ct) lct = lookup(ct_key, ct_P, ct_Pb, kc, n2c, C, HW, p, n1c, T);
  if (do_cc) lcc = lookup(cc_key, cc_P, cc_Pb, kcc, n2cc, 2 * C, HW, p, n1cc, T);
  const bool is_bg = first || (chg ? lcc.bg : lct.bg);
  const int age = is_bg ? 0 : fg_age[p] + 1;
  const bool lab_bg = is_bg || age >= absorb;
  fg_age[p] = age;
  is_bg_out[p] = is_bg;
  lab_bg_out[p] = lab_bg;
  const float lab = lab_bg ? 1.0f : 0.0f;
  if (do_ct) update(ct_key, ct_P, ct_Pb, kc, lct, n2c, C, HW, p, lab, oma, alpha);
  if (do_cc) update(cc_key, cc_P, cc_Pb, kcc, lcc, n2cc, 2 * C, HW, p, lab, oma, alpha);
}

template <typename S>
static void launch(void* ct_key, void* ct_P, void* ct_Pb, void* cc_key, void* cc_P, void* cc_Pb, void* fg_age,
                   const void* ckey, const void* cckey, const void* changed, const void* first, void* is_bg,
                   void* lab_bg, int H, int W, int C, int n2c, int n2cc, int n1c, int n1cc, int absorb, float T,
                   float oma, float alpha, cudaStream_t stream) {
  fgd_tables_kernel<S><<<tt_blocks(H * W, 256), 256, 0, stream>>>(
      static_cast<uint8_t*>(ct_key), static_cast<S*>(ct_P), static_cast<S*>(ct_Pb), static_cast<uint8_t*>(cc_key),
      static_cast<S*>(cc_P), static_cast<S*>(cc_Pb), static_cast<int32_t*>(fg_age), static_cast<const uint8_t*>(ckey),
      static_cast<const uint8_t*>(cckey), static_cast<const bool*>(changed), static_cast<const bool*>(first),
      static_cast<bool*>(is_bg), static_cast<bool*>(lab_bg), H, W, C, n2c, n2cc, n1c, n1cc, absorb, T, oma, alpha);
}

TT_EXPORT int tt_fgd_tables(void* ct_key, void* ct_P, void* ct_Pb, void* cc_key, void* cc_P, void* cc_Pb,
                            void* fg_age, const void* ckey, const void* cckey, const void* changed, const void* first,
                            void* is_bg, void* lab_bg, int H, int W, int C, int n2c, int n2cc, int n1c, int n1cc,
                            int absorb, int half, float T, float oma, float alpha, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (half) {
    launch<__half>(ct_key, ct_P, ct_Pb, cc_key, cc_P, cc_Pb, fg_age, ckey, cckey, changed, first, is_bg, lab_bg, H, W,
                   C, n2c, n2cc, n1c, n1cc, absorb, T, oma, alpha, stream);
  } else {
    launch<float>(ct_key, ct_P, ct_Pb, cc_key, cc_P, cc_Pb, fg_age, ckey, cckey, changed, first, is_bg, lab_bg, H, W,
                  C, n2c, n2cc, n1c, n1cc, absorb, T, oma, alpha, stream);
  }
  return (int)cudaGetLastError();
}
