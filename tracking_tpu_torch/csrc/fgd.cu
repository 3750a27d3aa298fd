// fgd_tables: FGD's Bayes-table phase, a thread per quad (4 adjacent pixels
// of the flat H*W planes).
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
// equals the pixel's, and the first entry of least P (strict <); then, for a
// match, its rank (the entries of larger P, or of equal P and lower index)
// and the verdict rank < N1 && 2*Pb > T*P; then the decay of every entry,
// the reinforcement of the match or the replacement of the least-P entry,
// whose key bytes alone are written. fg_age and the tables are updated IN
// PLACE; is_bg and lab_bg are new maps. `first` (t == 0) is read on the card.
//
// Float behaviour is the reference's: statistics are loaded as f32,
// computed in f32 (the build has -fmad=false, so a*b+c is a product and a
// sum), and stored once with round to nearest even; the constants T,
// 1 - alpha2 and alpha2 are Python doubles rounded once to f32.
//
// Bound on the H100: device-memory bytes, as chip_smoke.py's fgd_cost counts
// what the data needs: per pixel its key and the P of every entry of its
// table, the key bytes of the used entries (P > 0) up to the first match,
// the used entries' Pb, the words that change, `changed`, fg_age and the two
// masks. 177 B a pixel (0.049 ms at 720p) on the quiet clip's full tables.
// The first design, a thread per pixel, reached 14 % of that (0.34 ms on an
// H100, PERF.md section 6): it read each P three times by dependent 2-byte
// loads (lookup, rank, update), compared keys a byte at a time and stored
// every P and Pb. Here a thread owns a quad, and a block of kT = 32 threads
// 128 pixels:
//   - a key byte plane gives the quad one 4-byte word, a statistic plane one
//     8-byte (f16) or 16-byte (f32) word. The quad's keys are compared at once
//     (__vcmpeq4), channel after channel while one of its pixels still
//     agrees, the words of kG entries in flight together; the lookup stops
//     once every pixel has its match (the least P serves only a pixel
//     without one);
//   - P is copied once into shared memory by cp.async, a column per thread
//     (entry n at n * kT words of V: conflict-free for run-time entries), and
//     serves the lookup, the rank and the update; so do the pixels' key
//     words;
//   - one pass over the entries that a pixel of the quad uses (P != 0) takes
//     the rank and decays P and Pb; it reads Pb there once, kU entries' words
//     in flight, and keeps the updated entry's Pb for the verdict. That
//     entry's P and Pb are stored per pixel once the label is known;
//   - only what changes is stored: a 4-byte P or Pb word whose value
//     differs (the decay of a zero, or of an f16 subnormal whose product
//     rounds back to itself, leaves it as it was), fg_age where it changes;
//     a replaced entry's key bytes are written per pixel;
//   - a quad runs a table's loops only if one of its pixels consults it, so
//     a warp skips a table that none of its pixels consults; a quad with
//     pixels of both kinds runs both (chip_smoke.py times the noisy clip's
//     frame, where the kinds mix most, beside the same frame with every
//     pixel in one table; PERF.md section 6).
// Skipping Pb and the decay where P = 0 rests on an invariant of every state
// the algorithm reaches, held by tests/test_torch_fgd_kernel.py on
// fgd_tables_ref: Pb <= P entrywise, so P = 0 implies Pb = 0. Both start at
// 0, both decay by the same factor with monotone rounding, and an update
// adds alpha2 * lab <= alpha2 to Pb where it adds alpha2 to P (or sets
// Pb = alpha2 * lab <= alpha2 = P). A word that is read is decayed as it is,
// so the kernel departs from the plain version only on a state that breaks
// the invariant. VEC = false (H*W % 4 != 0 or an unaligned leaf) takes
// per-pixel accesses with the same arithmetic. Shared memory: kT x
// (max(N2c, N2cc) x 8 + 32) bytes in f16 (x 16 in f32), 11,264 B for the
// defaults: at most 19 blocks of one warp an SM. Blocks of 64 threads,
// kG = 4, 16 or every channel at once, kU = 8, Pb staged in shared memory
// as well, and whole-quad stores were each slower on an H100 (cut copies
// timed beside this one, not committed).
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kT = 32;            // threads a block, a quad each
constexpr int kG = 8;             // entries whose key words are in flight together
constexpr int kU = 4;             // entries whose Pb words are in flight together
constexpr int kMaxKey = 8;        // key bytes a pixel (ops/fgd.py MAX_KEY_BYTES)
constexpr int kMaxSmem = 232448;  // shared bytes a block can use

// A quad's 4 statistics as their raw bits R lie in memory: f16 two to a
// 4-byte word, f32 one.
template <typename R>
struct Quad;

template <>
struct Quad<uint16_t> {
  using V = uint2;
  static constexpr int kWords = 2;
  __device__ static uint32_t word(const V& v, int i) { return i == 0 ? v.x : v.y; }
  __device__ static void set_word(V& v, int i, uint32_t w) {
    if (i == 0) {
      v.x = w;
    } else {
      v.y = w;
    }
  }
  // the bits of word i that belong to the pixels of a byte mask (0xFF a pixel)
  __device__ static uint32_t word_mask(uint32_t lanes, int i) {
    return __byte_perm(lanes, 0, i == 0 ? 0x1100 : 0x3322);
  }
  __device__ static uint32_t bits(const V& v, int k) { return (word(v, k >> 1) >> (16 * (k & 1))) & 0xFFFFu; }
  __device__ static void put(V& v, int k, uint32_t b) {
    const int sh = 16 * (k & 1);
    set_word(v, k >> 1, (word(v, k >> 1) & ~(0xFFFFu << sh)) | (b << sh));
  }
  __device__ static float val(uint32_t b) { return __half2float(__ushort_as_half((unsigned short)b)); }
  __device__ static uint32_t round(float f) { return __half_as_ushort(__float2half_rn(f)); }
  __device__ static void decode(const V& v, float f[4]) {
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
  __device__ static V encode(const float f[4]) {
    const __half2 a = __floats2half2_rn(f[0], f[1]), b = __floats2half2_rn(f[2], f[3]);
    return V{*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b)};
  }
};

template <>
struct Quad<uint32_t> {
  using V = uint4;
  static constexpr int kWords = 4;
  __device__ static uint32_t word(const V& v, int i) { return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w; }
  __device__ static void set_word(V& v, int i, uint32_t w) {
    if (i == 0) v.x = w;
    else if (i == 1) v.y = w;
    else if (i == 2) v.z = w;
    else v.w = w;
  }
  __device__ static uint32_t word_mask(uint32_t lanes, int i) { return __byte_perm(lanes, 0, 0x1111 * i); }
  __device__ static uint32_t bits(const V& v, int k) { return word(v, k); }
  __device__ static void put(V& v, int k, uint32_t b) { set_word(v, k, b); }
  __device__ static float val(uint32_t b) { return __uint_as_float(b); }
  __device__ static uint32_t round(float f) { return __float_as_uint(f); }
  __device__ static void decode(const V& v, float f[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = __uint_as_float(word(v, k));
  }
  __device__ static V encode(const float f[4]) {
    return V{__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3])};
  }
};

// The quad at flat pixel i of a plane: its nv pixels (4 on the vector path).
template <bool VEC>
__device__ __forceinline__ uint32_t ld_bytes(const uint8_t* a, size_t i, int nv) {
  if (VEC) return *reinterpret_cast<const uint32_t*>(a + i);
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < nv) v |= (uint32_t)a[i + k] << (8 * k);
  return v;
}

template <bool VEC>
__device__ __forceinline__ void st_bytes(uint8_t* a, size_t i, int nv, uint32_t v) {
  if (VEC) {
    *reinterpret_cast<uint32_t*>(a + i) = v;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < nv) a[i + k] = (uint8_t)(v >> (8 * k));
}

template <typename R, bool VEC>
__device__ __forceinline__ typename Quad<R>::V ld_quad(const R* a, size_t i, int nv) {
  using V = typename Quad<R>::V;
  if (VEC) return *reinterpret_cast<const V*>(a + i);
  V v = {};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < nv) Quad<R>::put(v, k, a[i + k]);
  return v;
}

// The pixels of byte mask `lanes` take their values from nw, the others keep
// old's; the 4-byte words that then differ from old are stored (off the
// vector path, the pixels that differ).
template <typename R, bool VEC>
__device__ __forceinline__ void st_changed(R* a, size_t i, int nv, uint32_t lanes, const typename Quad<R>::V& old,
                                           const typename Quad<R>::V& nw) {
  using Q = Quad<R>;
#pragma unroll
  for (int j = 0; j < Q::kWords; ++j) {
    const uint32_t m = Q::word_mask(lanes, j);
    const uint32_t o = Q::word(old, j), w = (Q::word(nw, j) & m) | (o & ~m);
    if (w == o) continue;
    if (VEC) {
      reinterpret_cast<uint32_t*>(a + i)[j] = w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int kw = k * Q::kWords / 4;  // the word of pixel k
        if (kw == j && k < nv) {
          typename Q::V t = old;
          Q::set_word(t, j, w);
          if (Q::bits(t, k) != Q::bits(old, k)) a[i + k] = (R)Q::bits(t, k);
        }
      }
    }
  }
}

template <int B>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(B));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ bool has(uint32_t lanes, int k) { return (lanes >> (8 * k)) & 1u; }

struct Table {
  uint8_t* key;         // [N][Ck][H*W]
  void* P;              // [N][H*W], f16 or f32
  void* Pb;
  const uint8_t* pkey;  // the pixels' key, [Ck][H*W]
  int N, Ck, n1;
};

struct FgdArgs {
  Table ct, cc;
  int32_t* fg_age;
  const uint8_t* changed;  // bool
  const bool* first;
  uint8_t* is_bg;  // bool
  uint8_t* lab_bg;
  size_t HW;
  int n_max;  // entries of the deeper table: the shared columns' length
  int absorb;
  float T, oma, alpha;
};

// One table for the quad at p0: `lanes` (0xFF a pixel) are its pixels that
// consult it; where `verdict`, they take its verdict into bg (0xFF a
// pixel), and lab gains their labels (fg_age from age). col: this thread's
// shared column of P (entry n at n * kT), skey: of the pixels' key words.
template <typename R, bool VEC>
__device__ __forceinline__ void table(const FgdArgs& a, const Table& tb, uint32_t lanes, bool verdict,
                                      typename Quad<R>::V* col, uint32_t* skey, size_t p0, int nv, const int age[4],
                                      uint32_t& bg, uint32_t& lab) {
  using Q = Quad<R>;
  using V = typename Q::V;
  const size_t HW = a.HW, CkHW = (size_t)tb.Ck * HW;
  const int N = tb.N, Ck = tb.Ck;
  R* P = static_cast<R*>(tb.P) + p0;
  R* Pb = static_cast<R*>(tb.Pb) + p0;
  uint8_t* key = tb.key + p0;

  // P and the pixels' key into the shared columns
  for (int n = 0; n < N; ++n) {
    if (VEC) {
      cp_async<sizeof(V)>(col + n * kT, P + n * HW);
    } else {
      col[n * kT] = ld_quad<R, false>(P, n * HW, nv);
    }
  }
  for (int c = 0; c < Ck; ++c) {
    if (VEC) {
      cp_async<4>(skey + c * kT, tb.pkey + c * HW + p0);
    } else {
      skey[c * kT] = ld_bytes<false>(tb.pkey, c * HW + p0, nv);
    }
  }
  cp_async_wait_all();

  // the first match (the key words of kG entries at a time) and the first least P
  int fi[4], mi[4];
  float minv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    fi[k] = -1;
    mi[k] = 0;
    minv[k] = 0.0f;
  }
  uint32_t open = lanes;  // pixels still without a match
  for (int n0 = 0; n0 < N; n0 += kG) {
    uint32_t eq[kG], any = 0;  // per entry, the pixels whose key bytes agree so far
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int n = n0 + g;
      eq[g] = 0;
      if (n < N) {
        float p[4];
        Q::decode(col[n * kT], p);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (n == 0 || p[k] < minv[k]) {
            minv[k] = p[k];
            mi[k] = n;
          }
          if (p[k] > 0.0f) eq[g] |= 0xFFu << (8 * k);
        }
        eq[g] &= open;
        any |= eq[g];
      }
    }
    for (int c = 0; c < Ck && any; ++c) {
      const uint32_t kc = skey[c * kT];
      const uint8_t* kp = key + ((size_t)n0 * Ck + c) * HW;
      uint32_t kw[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) kw[g] = eq[g] ? ld_bytes<VEC>(kp, g * CkHW, nv) : 0u;
      any = 0;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        eq[g] &= __vcmpeq4(kw[g], kc);
        any |= eq[g];
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const uint32_t m = eq[g] & open;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (has(m, k)) fi[k] = n0 + g;
      open &= ~m;
    }
    if (open == 0) break;  // the least P serves only a pixel without a match
  }

  // one pass over the entries that a pixel of the quad uses (P != 0; an
  // unused entry keeps its zeros, and its Pb is 0 by the invariant in the
  // header): the match's rank (an unused entry never outranks a match,
  // whose P > 0), the decay of P and of Pb, read here once, kU entries' words
  // in flight; the updated entry's (at) Pb kept for the verdict
  float pm[4];
  int rank[4], at[4];
  uint32_t pb_at[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pm[k] = fi[k] >= 0 ? Q::val(Q::bits(col[fi[k] * kT], k)) : 0.0f;
    rank[k] = 0;
    at[k] = fi[k] >= 0 ? fi[k] : mi[k];
    pb_at[k] = 0;
  }
  for (int n0 = 0; n0 < N; n0 += kU) {
    V pb[kU];
    unsigned used = 0;  // bit u: entry n0 + u is used
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int n = n0 + u;
      pb[u] = V{};
      if (n < N) {
        const V v = col[n * kT];
        bool need = false;
#pragma unroll
        for (int j = 0; j < Q::kWords; ++j) need = need || (Q::word(v, j) & Q::word_mask(lanes, j)) != 0;
        if (need) {
          pb[u] = ld_quad<R, VEC>(Pb, n * HW, nv);
          used |= 1u << u;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int n = n0 + u;
      if ((used >> u) & 1u) {
        const V v = col[n * kT];
        float p[4], q[4];
        Q::decode(v, p);
        Q::decode(pb[u], q);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          rank[k] += (p[k] > pm[k] || (p[k] == pm[k] && n < fi[k])) ? 1 : 0;
          if (at[k] == n) pb_at[k] = Q::bits(pb[u], k);
          p[k] = p[k] * a.oma;
          q[k] = q[k] * a.oma;
        }
        st_changed<R, VEC>(P, n * HW, nv, lanes, v, Q::encode(p));
        st_changed<R, VEC>(Pb, n * HW, nv, lanes, pb[u], Q::encode(q));
      }
    }
  }

  // the verdict and the label; the updated entry's P and Pb over their
  // decayed values, a replaced entry's key
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!has(lanes, k)) continue;
    const uint32_t p_at = Q::bits(col[at[k] * kT], k);
    if (verdict) {
      const bool b = fi[k] >= 0 && rank[k] < tb.n1 && 2.0f * Q::val(pb_at[k]) > a.T * pm[k];
      if (b) bg |= 0xFFu << (8 * k);
      if (b || age[k] + 1 >= a.absorb) lab |= 0xFFu << (8 * k);
    }
    const float a_lab = a.alpha * (has(lab, k) ? 1.0f : 0.0f);
    const bool hit = fi[k] >= 0;
    P[at[k] * HW + k] = (R)Q::round(hit ? Q::val(p_at) * a.oma + a.alpha : a.alpha);
    Pb[at[k] * HW + k] = (R)Q::round(hit ? Q::val(pb_at[k]) * a.oma + a_lab : a_lab);
    if (!hit) {
      for (int c = 0; c < Ck; ++c) key[((size_t)at[k] * Ck + c) * HW + k] = (uint8_t)(skey[c * kT] >> (8 * k));
    }
  }
}

template <bool HALF, bool VEC>
__global__ void __launch_bounds__(kT) fgd_tables_kernel(FgdArgs a) {
  using R = std::conditional_t<HALF, uint16_t, uint32_t>;
  using V = typename Quad<R>::V;
  extern __shared__ __align__(16) uint8_t smem[];
  V* col = reinterpret_cast<V*>(smem) + threadIdx.x;
  uint32_t* skey = reinterpret_cast<uint32_t*>(smem + (size_t)a.n_max * kT * sizeof(V)) + threadIdx.x;
  const size_t p0 = 4 * ((size_t)blockIdx.x * kT + threadIdx.x);
  if (p0 >= a.HW) return;
  const int nv = a.HW - p0 < 4 ? (int)(a.HW - p0) : 4;
  const uint32_t vm = nv == 4 ? 0xFFFFFFFFu : (1u << (8 * nv)) - 1u;
  const bool first = *a.first;
  const uint32_t chg = ld_bytes<VEC>(a.changed, p0, nv) * 0xFFu;  // 0xFF a changed pixel
  int age[4];
  if (VEC) {
    const int4 v = *reinterpret_cast<const int4*>(a.fg_age + p0);
    age[0] = v.x;
    age[1] = v.y;
    age[2] = v.z;
    age[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) age[k] = k < nv ? a.fg_age[p0 + k] : 0;
  }
  // the first frame is all background; later, each pixel takes the verdict
  // of the table it consults
  uint32_t bg = first ? vm : 0u, lab = bg;
  const uint32_t ct = first ? vm : ~chg & vm;
  if (ct) table<R, VEC>(a, a.ct, ct, !first, col, skey, p0, nv, age, bg, lab);
  if (chg) table<R, VEC>(a, a.cc, chg, !first, col, skey, p0, nv, age, bg, lab);
  st_bytes<VEC>(a.is_bg, p0, nv, bg & 0x01010101u);
  st_bytes<VEC>(a.lab_bg, p0, nv, lab & 0x01010101u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int na = has(bg, k) ? 0 : age[k] + 1;
    if (k < nv && na != age[k]) a.fg_age[p0 + k] = na;
  }
}

template <bool HALF, bool VEC>
int launch(const FgdArgs& a, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(fgd_tables_kernel<HALF, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = (size_t)kT * (a.n_max * (HALF ? 8 : 16) + kMaxKey * 4);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;  // a table too deep for the shared columns
  const size_t quads = (a.HW + 3) / 4;
  fgd_tables_kernel<HALF, VEC><<<(unsigned)((quads + kT - 1) / kT), kT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int n) { return (uintptr_t)p % n == 0; }

}  // namespace

TT_EXPORT int tt_fgd_tables(void* ct_key, void* ct_P, void* ct_Pb, void* cc_key, void* cc_P, void* cc_Pb,
                            void* fg_age, const void* ckey, const void* cckey, const void* changed, const void* first,
                            void* is_bg, void* lab_bg, int H, int W, int C, int n2c, int n2cc, int n1c, int n1cc,
                            int absorb, int half, float T, float oma, float alpha, void* stream_) {
  if (C < 1 || 2 * C > kMaxKey || n2c < 1 || n2cc < 1) return (int)cudaErrorInvalidValue;
  FgdArgs a;
  a.ct = {static_cast<uint8_t*>(ct_key), ct_P, ct_Pb, static_cast<const uint8_t*>(ckey), n2c, C, n1c};
  a.cc = {static_cast<uint8_t*>(cc_key), cc_P, cc_Pb, static_cast<const uint8_t*>(cckey), n2cc, 2 * C, n1cc};
  a.fg_age = static_cast<int32_t*>(fg_age);
  a.changed = static_cast<const uint8_t*>(changed);
  a.first = static_cast<const bool*>(first);
  a.is_bg = static_cast<uint8_t*>(is_bg);
  a.lab_bg = static_cast<uint8_t*>(lab_bg);
  a.HW = (size_t)H * W;
  a.n_max = n2c > n2cc ? n2c : n2cc;
  a.absorb = absorb;
  a.T = T;
  a.oma = oma;
  a.alpha = alpha;
  // the vector path: whole quads, every plane 4-byte aligned, a quad's
  // statistics and fg_age on their own widths
  const int sw = half ? 8 : 16;
  const bool vec = a.HW % 4 == 0 && aligned(ct_key, 4) && aligned(cc_key, 4) && aligned(ckey, 4) &&
                   aligned(cckey, 4) && aligned(changed, 4) && aligned(is_bg, 4) && aligned(lab_bg, 4) &&
                   aligned(fg_age, 16) && aligned(ct_P, sw) && aligned(ct_Pb, sw) && aligned(cc_P, sw) &&
                   aligned(cc_Pb, sw);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (half) return vec ? launch<true, true>(a, stream) : launch<true, false>(a, stream);
  return vec ? launch<false, true>(a, stream) : launch<false, false>(a, stream);
}
