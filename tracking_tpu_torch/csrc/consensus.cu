// consensus: SuBSENSE's and LOBSTER's sample consensus with deferred bank
// writes, channels (C = 1 or 3) in a loop.
//
// Replaces tracking_tpu/ops/pallas_consensus.py:consensus_pallas (its
// kernel _make_kernel with _apply_pending_stage and _consensus_values). Per
// pixel, in order:
//   1. replay frame t-1's pending log: decode the control word, resolve the
//      3x3/5x5 spread pick from the neighbours' packed values through an
//      interior-replicated clamp (sources clamped into the 2-px ROI
//      interior), and write the <= 2 touched slots IN PLACE - the spread
//      after the self write, so it wins on a shared slot. Race-free: a
//      pixel's writes touch only its own slots and read only the packed
//      values, never another pixel's bank;
//   2. bg_sum = the sum of the N colour slots after the writes;
//   3. the intra LBSP descriptor from 16 edge-clamped neighbours;
//   4. the walk over the N samples, stopping once `required` good samples
//      are counted. The TPU kernel stops per 16x256 tile; per pixel is exact
//      for the same reason (skipped samples could only touch dead lanes).
//
// Bound on the H100: device-memory bytes. At 720p colour the banks are
// 414.7 MB (50 x 921,600 px x (1 + 2) bytes x 3 channels); bg_sum reads every
// colour slot (138 MB) and the walk reads the first few samples of both
// banks for background pixels and up to all 50 for foreground ones. The
// banks stay in place (no copy). Every kernel of this file runs the phases
// below ("three phases"): a tile's colour slots read once with 16-byte
// copies, only the 32-byte sectors the replay changes written back, and a
// walk with byte-SIMD descriptors; read_walk_kernel runs the walk alone on
// const banks.
//
// Thresholds are f32 expressions the reference evaluates without fused
// multiply-adds and with XLA's reciprocal product for a constant divisor:
// build with -fmad=false, and pass 1/div as the f32 `inv_div`.
//
// Slab mode (E > 0), for the row-sharded path (parallel/spatial.py): the
// planes and the pending values arrive as [H + 2E, W] slabs of this shard's
// H owned rows with E halo rows above and below (tracking_tpu's row_ext
// contract). Their contents already carry the global row clamps - the planes
// the edge clamp, the pending values the ROI-interior clamp - so in slab mode
// the kernel reads rows E + y +/- d without a row clamp; columns keep their
// clamps. The banks, the maps and the outputs stay owned-size [H, W].
// consensus_kernel, lobster_kernel (the planes and its pending values) and
// read_walk_kernel (the planes) take it; fused_kernel does not.
//
// The file's other kernels share these steps as device functions:
// fused_kernel (consensus_kernel's phases ct_replay and ct_walk, then the
// feedback stage of feedback.cuh and the next frame's pending log),
// read_walk_kernel (ct_stage and ct_walk: steps 3-4 on read-only banks,
// consensus v3) and lobster_kernel (ct_replay and ct_walk with LOBSTER's
// threshold function and sample test, chosen at compile time by the
// Consensus template argument).
#include "common.cuh"
#include "feedback.cuh"

struct Banks {
  uint8_t* col[3];
  uint16_t* desc[3];
  const int32_t* vals[3];
};

// The banks as read_walk_kernel reads them.
struct ConstBanks {
  const uint8_t* col[3];
  const uint16_t* desc[3];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

__device__ __forceinline__ int floordiv2(int v) { return v >= 0 ? v / 2 : -((1 - v) / 2); }

// NB5 index k (0..23) -> (dx, dy): the 5x5 window without its centre, rows
// y = 2..-2, columns x = -2..2.
__device__ __forceinline__ void nb5_offset(int k, int& dx, int& dy) {
  int idx = k < 12 ? k : k + 1;
  dy = 2 - idx / 5;
  dx = idx % 5 - 2;
}

// LBSP threshold of a u8 value (pallas_consensus._thr_closed_form)
__device__ __forceinline__ int lbsp_thr(int v, float delta, float rel, float inv_div, float hi) {
  float vf = (float)v * rel;
  float base = fminf(fmaxf(rintf(vf * inv_div), 0.0f), 255.0f);
  float lo = ceilf(vf * 0.25f);
  float lower = fminf(base, lo);
  float upper = fmaxf(base, hi);
  return (int)fminf(fmaxf(base + delta, lower), upper);
}

// LOBSTER's LBSP threshold of a u8 value (lbsp_family.LOBSTER._thr_fn):
// clip(rint((v*rel + offset) * (1/div)), 0, 255)
__device__ __forceinline__ int lobster_thr(int v, float rel, float offset, float inv_div) {
  return (int)fminf(fmaxf(rintf(((float)v * rel + offset) * inv_div), 0.0f), 255.0f);
}

// The pending values' row of a spread source at global offset -dy from row
// y: clamped into the ROI interior, or, in slab mode, the slab row that holds
// that clamp already.
__device__ __forceinline__ int src_row(int y, int dy, int H, int E) {
  return E > 0 ? E + y - dy : clampi(y - dy, 2, H - 3);
}

// ---------------------------------------------------------------------------
// consensus_kernel: one block of CT_T threads per CT_H x 64 tile of pixels, in
// three phases that share the block's shared memory (header, steps 1-4);
// ct_replay runs phase A, ct_walk phases B and C, and fused_kernel calls both:
//   A. replay and bg_sum: the tile's N colour slot planes of every channel
//      are copied into shared memory with 16-byte cp.async copies while each
//      pixel's thread decodes its pending log (pending_writes) and writes the
//      descriptor slots to the banks; ct_stage fills the walk's plane tile and
//      threshold table meanwhile. The colour slots are written into the
//      shared copy, and only the 32-byte sectors that changed go back to the
//      banks, whole. bg_sum adds the shared copy four pixels a word, u16 sums
//      in 32-bit lanes (50 x 255 fits in 16 bits; integer sums do not depend
//      on their order);
//   B. the walk's first CT_BATCH samples, one thread per pixel: the 16 LBSP
//      neighbours come from a shared tile of the planes with its 2-px halo,
//      four to a register (lbsp_pack), and each descriptor takes 16 byte-SIMD
//      steps (lbsp_bits); the threshold of a value is a shared table; the
//      descriptors of CT_BATCH samples are loaded before the first is tested,
//      the stop rule still applies sample by sample, and the colours come
//      from the shared copy (read_walk_kernel: from the banks, loaded with
//      the descriptors);
//   C. the pixels whose walk has not stopped are queued in shared memory and
//      every thread of the block walks the queue densely. A pixel's result
//      does not depend on which thread computes it.
// Why: the earlier one-thread-per-pixel kernel (0.61 ms on an H100 at 720p
// colour, 96 registers) spent about half its time in the replay's slot
// writes, one partial 32-byte sector each (colour and descriptor about
// equally), and most of the rest in the walk's scalar descriptor steps, with
// a third of the lanes idle beside foreground pixels (PERF.md section 6).
// The descriptor slots are still written one at a time: staging them would
// read the whole descriptor bank, twice the bytes of the colour bank.
#define CT_W 64                 // tile columns
#define CT_H 4                  // tile rows
#define CT_T (CT_W * CT_H)      // threads: one per pixel
#define CT_SLOT (CT_H * 64 + 32)  // shared bytes a slot plane of the tile: its rows + 32 B that spread the banks
#define CT_BATCH 4              // descriptors loaded before the first is tested
#define CT_PW (CT_W + 4)        // the planes' shared tile, 2-px halo
#define CT_PH (CT_H + 4)

// SuBSENSE's kernels' arguments, over the banks they write (Banks:
// consensus_kernel, fused_kernel) or only read (ConstBanks: read_walk_kernel,
// which leaves ctrl, bg_sum and vec unset).
template <class B>
struct ConsArgsT {
  const uint8_t* planes[3];
  B banks;
  const int32_t* ctrl;
  const float* R;
  const bool* unstable;
  const int32_t* required;
  const int32_t* lut_delta;
  int32_t* count;
  int32_t* mind;
  int32_t* mins;
  int32_t* intra;
  int32_t* bg_sum;
  int N, H, W, E;
  float rel, inv_div, hi;
  int min_cd, desc_off;
  int vec;  // W % 16 == 0 and 16-byte aligned colour banks: whole 16-byte copies
};
using ConsArgs = ConsArgsT<Banks>;
using ReadArgs = ConsArgsT<ConstBanks>;

// lobster_kernel's arguments: ConsArgs's fields for the replay and the walk,
// and LOBSTER's fixed thresholds in place of R, unstable and required. E is
// the slab mode's halo, read by ct_replay and ct_stage as consensus_kernel's.
struct LobsterArgs {
  const uint8_t* planes[3];
  Banks banks;
  const int32_t* ctrl;
  int32_t* count;
  int32_t* intra;
  int32_t* bg_sum;
  int N, H, W, E;
  float rel, offset, inv_div;
  int c_sc, d_sc, c_tot, d_tot, req;
  int vec;
};

// Which consensus a phase computes, a compile-time policy of ct_stage,
// ct_replay, walk_ctx, walk_samples and ct_walk: SuBSENSE's threshold table
// (lbsp_thr with lut_delta) and sample test (thresholds from R and unstable,
// the descriptor distance the mean of the intra and inter distances, the
// requirement map), or LOBSTER's (lobster_thr; fixed thresholds, the inter
// distance alone, a scalar requirement, only the count written).
enum class Consensus { SuBSENSE, LOBSTER };

// A pixel's pending writes, decoded from its control word (header, step 1):
// the slot of the self write and of the spread (-1: none) and their packed
// values. LOBSTER's log sets only 3x3 spreads (u5 = 0 with the 5x5 fire bit
// clear), so the same decode serves it.
template <int C>
struct PendingWrites {
  int slot1, slotn;
  int own[C], nb[C];
};

template <int C>
__device__ __forceinline__ PendingWrites<C> pending_writes(const Banks& banks, const int32_t* __restrict__ ctrl_map,
                                                           int x, int y, int p, int N, int H, int W, int E) {
  const int ctrl = ctrl_map[p];
  const bool upd1 = (ctrl & 1) != 0;
  const int slot1 = (ctrl >> 1) & 63;
  const int u3 = (ctrl >> 7) & 31;
  const int u5 = (ctrl >> 12) & 31;
  const int slot3 = (ctrl >> 17) & 63;
  const int slot5 = (ctrl >> 23) & 63;
  int dx, dy;
  bool ok3 = false, ok5 = false;
  if (u3 < 24) {
    nb5_offset(u3, dx, dy);
    if (dx >= -1 && dx <= 1 && dy >= -1 && dy <= 1) {
      int q = src_row(y, dy, H, E) * W + clampi(x - dx, 2, W - 3);
      ok3 = ((banks.vals[0][q] >> 24) & 1) != 0;
    }
  }
  if (u5 < 24) {
    nb5_offset(u5, dx, dy);
    int q = src_row(y, dy, H, E) * W + clampi(x - dx, 2, W - 3);
    ok5 = ((banks.vals[0][q] >> 24) & 2) != 0;
  }
  const bool okn = ok3 || ok5;
  const int u = ok3 ? u3 : u5;
  const int slotn = ok3 ? slot3 : slot5;
  PendingWrites<C> w;
  w.slot1 = upd1 && slot1 < N ? slot1 : -1;
  w.slotn = okn && slotn < N ? slotn : -1;
  int q_nb = 0;
  if (w.slotn >= 0) {
    nb5_offset(u, dx, dy);
    q_nb = src_row(y, dy, H, E) * W + clampi(x - dx, 2, W - 3);
  }
  const int pv = (y + E) * W + x;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    w.own[c] = w.slot1 >= 0 ? banks.vals[c][pv] : 0;
    w.nb[c] = w.slotn >= 0 ? banks.vals[c][q_nb] : 0;
  }
  return w;
}

// The 16 LBSP neighbours of tile pixel (r, cx), from a shared plane tile
// with a 2-px halo, packed four to a word: neighbour k = 4i + b sits in
// byte i of word 3 - b, the order lbsp_bits reads.
__device__ __forceinline__ void lbsp_pack(const uint8_t* pl, int r, int cx, uint32_t nb[4]) {
  // the offsets (x, y) in bit order (tracking_tpu/ops/lbsp.py OFFSETS)
  constexpr int dx[16] = {-2, 2, 0, 0, -2, 2, 2, -2, 0, -1, 0, 1, -1, 1, 1, -1};
  constexpr int dy[16] = {0, 0, -2, 2, 2, -2, 2, -2, 1, 0, -1, 0, -1, 1, -1, 1};
  nb[0] = nb[1] = nb[2] = nb[3] = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t v = pl[(r + 2 + dy[k]) * CT_PW + cx + 2 + dx[k]];
    nb[3 - (k & 3)] |= v << (8 * (k >> 2));
  }
}

// The LBSP descriptor of a value s against the packed neighbours: bit k set
// where |nb_k - s| > t. s4 is s in all four bytes; K is 255 - t in all four
// bytes and K7 = K & 0x7f7f7f7f. Per byte, d > t exactly when d + (255 - t)
// carries out of bit 7: the carry is the majority of d's bit 7, K's bit 7
// and the carry into bit 7, which the 7-bit sums give without crossing
// bytes. The four words' carry bits are then gathered into bits 0-15.
__device__ __forceinline__ int lbsp_bits(const uint32_t nb[4], uint32_t s4, uint32_t K, uint32_t K7) {
  uint32_t g[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t d = __vabsdiffu4(nb[w], s4);
    const uint32_t lo = (d & 0x7f7f7f7fu) + K7;
    g[w] = (d & K) | (d & lo) | (K & lo);
  }
  const uint32_t v = (g[0] & 0x80808080u) | ((g[1] >> 1) & 0x40404040u) | ((g[2] >> 2) & 0x20202020u) |
                     ((g[3] >> 3) & 0x10101010u);
  const uint32_t y = v >> 4;  // byte i: bits 3..0 = neighbours 4i..4i+3
  return (int)__byte_perm(y | (y >> 4), 0, 0x4420);
}

// A pixel's walk context: packed neighbours, values, intra descriptors, the
// requirement and, for SuBSENSE, the colour and descriptor thresholds from R
// and the previous unstable mask (the reference's f32 expressions, in its
// order). LOBSTER's thresholds are the arguments' constants.
template <int C>
struct WalkCtx {
  uint32_t nb[C][4];
  int px[C], intra[C];
  int ct, dt, sc, req;
};

// SuBSENSE's requirement at pixel p: the map's, zeroed outside the 2-px ROI
// for the fused step (FUSED).
template <bool FUSED, class A>
__device__ __forceinline__ int walk_req(const A& a, int x, int y, int p) {
  if (FUSED && !(y >= 2 && y <= a.H - 3 && x >= 2 && x <= a.W - 3)) return 0;
  return a.required[p];
}

template <int C, Consensus K, bool FUSED, class A>
__device__ __forceinline__ void walk_ctx(WalkCtx<C>& w, const A& a, const uint8_t* s_pl, const uint2* lut, int r,
                                         int cx, int x, int y, int p) {
  float R = 0.0f;
  bool unst = false;
  if constexpr (K == Consensus::LOBSTER) {
    w.req = a.req;
  } else {
    R = a.R[p];
    unst = a.unstable[p];
    w.req = walk_req<FUSED>(a, x, y, p);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const uint8_t* pl = s_pl + c * CT_PH * CT_PW;
    lbsp_pack(pl, r, cx, w.nb[c]);
    w.px[c] = pl[(r + 2) * CT_PW + cx + 2];
    const uint2 L = lut[w.px[c]];
    w.intra[c] = lbsp_bits(w.nb[c], (uint32_t)w.px[c] * 0x01010101u, L.x, L.y);
  }
  if constexpr (K == Consensus::SuBSENSE) {
    const int min_cd = a.min_cd, desc_off = a.desc_off;
    const float ctf = R * (float)min_cd - (unst ? 0.0f : (float)(min_cd / 5));
    int ct = (int)ctf;
    if (C == 1) ct = floordiv2(ct);
    const int n_exp = (int)floorf(R + 0.5f);
    const int pow2 = (n_exp >= 0 && n_exp < 32) ? (int)(1u << n_exp) : 0;
    w.ct = ct;
    w.dt = pow2 + desc_off + (unst ? desc_off : 0);
    w.sc = C == 3 ? floordiv2(ct * 3) : ct;
  }
}

// Where the walk reads a sample's colour: the tile's shared copy that
// ct_replay filled (consensus_kernel, fused_kernel), or the banks in device
// memory, CT_BATCH bytes at a time with the descriptors (read_walk_kernel).
enum class ColSrc { Shared, Banks };

// The walk from sample j until j_end, stopping once w.req good samples are
// counted; descriptors from the banks, CT_BATCH loads at a time, colours
// from SRC (Shared: byte `off` of a slot plane of s_col). SuBSENSE: a sample
// is good where, per channel, the colour distance cd and the descriptor
// distance dd (the mean of the intra and the inter descriptor's Hamming
// distances to the sample's) pass the thresholds: C = 1 cd <= ct, dd <= dt
// and min(dd / 4 * 15 + cd, 255) <= ct; C = 3 per channel cd <= sc and
// min(dd / 2 * 15 + cd, 255) <= sc, and their sums within 3 dt and 3 ct.
// LOBSTER: dd is the inter descriptor's Hamming distance alone; per channel
// cd <= c_sc and dd <= d_sc, and for C = 3 the sums of cd and dd within c_tot
// and d_tot; mind and mins are left as they are.
template <int C, ColSrc SRC, Consensus K, class A>
__device__ __forceinline__ void walk_samples(const WalkCtx<C>& w, const A& a, const uint8_t* s_col, int off, int p,
                                             size_t HW, const uint2* lut, int j_end, int& j, int& count, int& mind,
                                             int& mins) {
  const int N = a.N;
  const auto& banks = a.banks;
  while (j < j_end && count < w.req) {
    int sd[CT_BATCH][C];
    uint32_t sc[C];  // ColSrc::Banks: the batch's colour bytes, byte b of sample j + b
#pragma unroll
    for (int c = 0; c < C; ++c) sc[c] = 0;
#pragma unroll
    for (int b = 0; b < CT_BATCH; ++b)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        sd[b][c] = j + b < N ? banks.desc[c][(size_t)(j + b) * HW + p] : 0;
        if (SRC == ColSrc::Banks && j + b < N) sc[c] |= (uint32_t)banks.col[c][(size_t)(j + b) * HW + p] << (8 * b);
      }
#pragma unroll
    for (int b = 0; b < CT_BATCH; ++b) {
      const int jj = j + b;
      if (jj < N && count < w.req) {
        // a channel whose colour distance already fails makes the sample
        // bad, so the descriptors after it are not computed (the totals
        // count only for good samples)
        int tot_desc = 0, tot_sum = 0;
        bool good = true;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (!good) break;
          const int s_col_v =
              SRC == ColSrc::Shared ? s_col[(c * N + jj) * CT_SLOT + off] : (int)((sc[c] >> (8 * b)) & 0xFFu);
          const int cd = abs(w.px[c] - s_col_v);
          if constexpr (K == Consensus::LOBSTER) {
            if (cd > a.c_sc) {
              good = false;
              break;
            }
            const uint2 L = lut[s_col_v];
            const int dd = __popc(lbsp_bits(w.nb[c], (uint32_t)s_col_v * 0x01010101u, L.x, L.y) ^ sd[b][c]);
            good = dd <= a.d_sc;
            tot_desc += dd;
            tot_sum += cd;
          } else {
            if (cd > (C == 1 ? w.ct : w.sc)) {
              good = false;
              break;
            }
            const uint2 L = lut[s_col_v];
            const int inter = lbsp_bits(w.nb[c], (uint32_t)s_col_v * 0x01010101u, L.x, L.y);
            const int dd = (__popc(w.intra[c] ^ sd[b][c]) + __popc(inter ^ sd[b][c])) >> 1;
            if (C == 1) {
              const int sum_d = min((dd / 4) * 15 + cd, 255);
              good = (dd <= w.dt) && (sum_d <= w.ct);
              tot_desc = dd;
              tot_sum = sum_d;
            } else {
              const int sum_c = min((dd / 2) * 15 + cd, 255);
              good = sum_c <= w.sc;
              tot_desc += dd;
              tot_sum += sum_c;
            }
          }
        }
        if constexpr (K == Consensus::LOBSTER) {
          if (C == 3) good = good && (tot_desc <= a.d_tot) && (tot_sum <= a.c_tot);
          count += good;
        } else {
          if (C == 3) good = good && (tot_desc <= w.dt * 3) && (tot_sum <= w.ct * 3);
          if (good) {
            ++count;
            mind = min(mind, tot_desc);
            mins = min(mins, tot_sum);
          }
        }
      }
    }
    j += CT_BATCH;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int C>
__host__ __device__ constexpr int ct_smem_bytes(int N) {
  // colour copy, plane tile, threshold table, dirty flags (16-aligned), queue, queue length;
  // N = 0: no colour copy and no dirty flags (read_walk_kernel)
  return C * N * CT_SLOT + C * CT_PH * CT_PW + 256 * 8 + (C * N * 2 * CT_H + 15) / 16 * 16 + CT_T * 4 + 16;
}

// The tile's shared memory, as ct_smem_bytes lays it out.
struct CtShared {
  uint8_t* col;    // [C][N][CT_SLOT] the colour slots
  uint8_t* pl;     // [C][CT_PH][CT_PW] the planes with a 2-px halo
  uint2* lut;      // value -> (K, K7) of its threshold
  uint8_t* dirty;  // [C][N][rows x 2 sectors]
  unsigned* q;     // the open walks
  unsigned* qn;
};

template <int C>
__device__ __forceinline__ CtShared ct_shared(uint8_t* smem, int N) {
  CtShared s;
  s.col = smem;
  s.pl = s.col + C * N * CT_SLOT;
  s.lut = reinterpret_cast<uint2*>(s.pl + C * CT_PH * CT_PW);
  s.dirty = reinterpret_cast<uint8_t*>(s.lut + 256);
  s.q = reinterpret_cast<unsigned*>(s.dirty + (C * N * 2 * CT_H + 15) / 16 * 16);
  s.qn = s.q + CT_T;
  return s;
}

// The walk's inputs in shared memory, for ct_replay and read_walk_kernel: the
// tile's planes with their 2-px halo (edge-clamped; in slab mode the slab's
// rows) and the threshold table of consensus K (the same table serves the
// intra and the inter descriptors). Every thread t of the block calls it with
// the frame's H, W and E; the caller empties the queue and synchronises
// before the walk.
template <int C, Consensus K, class A>
__device__ __forceinline__ void ct_stage(const A& a, const CtShared& s, int t, int x0, int y0, int H, int W, int E) {
  const int Hp = H + 2 * E;
  for (int i = t; i < C * CT_PH * CT_PW; i += CT_T) {
    const int c = i / (CT_PH * CT_PW), rc = i % (CT_PH * CT_PW);
    const int yy = clampi(y0 + rc / CT_PW - 2 + E, 0, Hp - 1), xx = clampi(x0 + rc % CT_PW - 2, 0, W - 1);
    s.pl[i] = a.planes[c][(size_t)yy * W + xx];
  }
  for (int v = t; v < 256; v += CT_T) {
    int thr;
    if constexpr (K == Consensus::LOBSTER) {
      thr = lobster_thr(v, a.rel, a.offset, a.inv_div);
    } else {
      thr = lbsp_thr(v, (float)a.lut_delta[0], a.rel, a.inv_div, a.hi);
    }
    const uint32_t k4 = (uint32_t)(255 - thr) * 0x01010101u;
    s.lut[v] = make_uint2(k4, k4 & 0x7f7f7f7fu);
  }
}

// Phase A, shared by consensus_kernel, fused_kernel and lobster_kernel: the
// replay of the pending log into the banks (colours through the shared copy,
// descriptors straight) and bg_sum; ct_stage fills the walk's inputs for
// consensus K meanwhile. Every thread of the block calls it.
template <int C, Consensus K, class A>
__device__ __forceinline__ void ct_replay(const A& a, const CtShared& s, int x0, int y0) {
  const int N = a.N, H = a.H, W = a.W, E = a.E;
  const size_t HW = (size_t)H * W;
  const int t = threadIdx.x, lane = t & 31;
  const int n_chunks = N * CT_H * 4;  // 16-byte chunks of a channel's slot planes in the tile

  // this pixel's pending writes; the colour slots into shared memory
  const int r = t >> 6, cx = t & 63;
  const int x = x0 + cx, y = y0 + r;
  const int p = y * W + x;
  PendingWrites<C> pw;
  pw.slot1 = pw.slotn = -1;
  if (x < W && y < H) pw = pending_writes<C>(a.banks, a.ctrl, x, y, p, N, H, W, E);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    for (int i = t; i < n_chunks; i += CT_T) {
      const int j = i / (CT_H * 4), rr = (i >> 2) % CT_H, k = i & 3;
      const int yy = y0 + rr, xx = x0 + 16 * k;
      if (yy < H && xx < W) {
        uint8_t* dst = s.col + (c * N + j) * CT_SLOT + rr * 64 + 16 * k;
        const uint8_t* src = a.banks.col[c] + (size_t)j * HW + (size_t)yy * W + xx;
        if (a.vec) {
          cp_async16(dst, src);
        } else {
          for (int b = 0; b < 16 && xx + b < W; ++b) dst[b] = src[b];
        }
      }
    }
  }
  ct_stage<C, K>(a, s, t, x0, y0, H, W, E);
  for (int i = t; i < C * N * 2 * CT_H; i += CT_T) s.dirty[i] = 0;
  if (t == 0) *s.qn = 0;
  // the descriptor writes go straight to the banks
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (pw.slot1 >= 0) a.banks.desc[c][(size_t)pw.slot1 * HW + p] = (uint16_t)((pw.own[c] >> 8) & 0xFFFF);
    if (pw.slotn >= 0) a.banks.desc[c][(size_t)pw.slotn * HW + p] = (uint16_t)((pw.nb[c] >> 8) & 0xFFFF);
  }
  cp_async_wait_all();
  __syncthreads();
  const int off = r * 64 + cx;        // this pixel's byte in a slot plane of the copy
  const int sec = r * 2 + (cx >> 5);  // its 32-byte sector
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (pw.slot1 >= 0) {
      s.col[(c * N + pw.slot1) * CT_SLOT + off] = (uint8_t)(pw.own[c] & 0xFF);
      s.dirty[(c * N + pw.slot1) * 2 * CT_H + sec] = 1;
    }
    if (pw.slotn >= 0) {  // after the self write: the spread wins a shared slot
      s.col[(c * N + pw.slotn) * CT_SLOT + off] = (uint8_t)(pw.nb[c] & 0xFF);
      s.dirty[(c * N + pw.slotn) * 2 * CT_H + sec] = 1;
    }
  }
  __syncthreads();

  // the changed sectors back to the banks, whole
#pragma unroll
  for (int c = 0; c < C; ++c) {
    for (int i = t; i < n_chunks; i += CT_T) {
      const int j = i / (CT_H * 4), rr = (i >> 2) % CT_H, k = i & 3;
      const int yy = y0 + rr, xx = x0 + 16 * k;
      if (s.dirty[(c * N + j) * 2 * CT_H + rr * 2 + (k >> 1)] && yy < H && xx < W) {
        const uint8_t* src = s.col + (c * N + j) * CT_SLOT + rr * 64 + 16 * k;
        uint8_t* dst = a.banks.col[c] + (size_t)j * HW + (size_t)yy * W + xx;
        if (a.vec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int b = 0; b < 16 && xx + b < W; ++b) dst[b] = src[b];
        }
      }
    }
  }
  // bg_sum: lane = (slot group g, quad of 4 pixels); groups joined by shuffles
  const int q = (t >> 5) * 8 + (lane & 7), g = lane >> 3;
  const int qoff = (q >> 4) * 64 + 4 * (q & 15);
  uint32_t lo[C], hi[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    lo[c] = hi[c] = 0;
    for (int j = g; j < N; j += 4) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(s.col + (c * N + j) * CT_SLOT + qoff);
      lo[c] += v & 0x00ff00ffu;
      hi[c] += (v >> 8) & 0x00ff00ffu;
    }
    lo[c] += __shfl_xor_sync(0xffffffffu, lo[c], 8);
    hi[c] += __shfl_xor_sync(0xffffffffu, hi[c], 8);
    lo[c] += __shfl_xor_sync(0xffffffffu, lo[c], 16);
    hi[c] += __shfl_xor_sync(0xffffffffu, hi[c], 16);
  }
  const int yq = y0 + (q >> 4), xq = x0 + 4 * (q & 15);
  if (g == 0 && yq < H) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int s4[4] = {(int)(lo[c] & 0xffff), (int)(hi[c] & 0xffff), (int)(lo[c] >> 16), (int)(hi[c] >> 16)};
      int32_t* o = a.bg_sum + (size_t)c * HW + (size_t)yq * W + xq;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (xq + i < W) o[i] = s4[i];
    }
  }
}

// Where the walk's results go. consensus_kernel (FUSED = false) writes the
// global maps; fused_kernel keeps them in the tile's shared memory for its
// feedback phase: res[pixel] = count | mind << 8 | mins << 16 and
// pv[c][pixel] = value | intra << 8 (the next pending log's packing), and
// walks with the requirement zeroed outside the 2-px ROI.
struct WalkOut {
  uint32_t* res;  // [CT_T]
  uint32_t* pv;   // [C][CT_T]
};

template <bool FUSED, Consensus K, class A>
__device__ __forceinline__ void walk_result(const A& a, const WalkOut& o, int tp, int p, int count, int mind,
                                            int mins) {
  if constexpr (K == Consensus::LOBSTER) {
    a.count[p] = count;
  } else if (FUSED) {
    o.res[tp] = (uint32_t)count | (uint32_t)mind << 8 | (uint32_t)mins << 16;
  } else {
    a.count[p] = count;
    a.mind[p] = mind;
    a.mins[p] = mins;
  }
}

// Phases B and C, shared: the walk's first CT_BATCH samples one thread per
// pixel, then the open walks densely from a shared queue, with the colours
// from SRC and consensus K's sample test. Needs ct_stage's inputs in place
// (after a __syncthreads). Ends with the block in step after phase B; phase
// C's results are visible to the block only after the caller's
// __syncthreads.
template <int C, bool FUSED, ColSrc SRC, Consensus K, class A>
__device__ __forceinline__ void ct_walk(const A& a, const CtShared& s, const WalkOut& o, int x0, int y0) {
  const int N = a.N, W = a.W;
  const size_t HW = (size_t)a.H * W;
  const int t = threadIdx.x, lane = t & 31;
  const int r = t >> 6, cx = t & 63;
  const int x = x0 + cx, y = y0 + r;
  const bool in = x < W && y < a.H;
  const int p = y * W + x;

  // -- B. the walk's first samples, one thread per pixel ----------------------
  WalkCtx<C> w;
  int count = 0, mind = 16 * C, mins = 255 * C, j = 0;
  if (in) {
    walk_ctx<C, K, FUSED>(w, a, s.pl, s.lut, r, cx, x, y, p);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (FUSED) {
        o.pv[c * CT_T + t] = (uint32_t)w.px[c] | (uint32_t)w.intra[c] << 8;
      } else {
        a.intra[(size_t)c * HW + p] = w.intra[c];
      }
    }
    walk_samples<C, SRC, K>(w, a, s.col, r * 64 + cx, p, HW, s.lut, CT_BATCH, j, count, mind, mins);
  }
  const bool open = in && count < w.req && j < N;
  if (in && !open) walk_result<FUSED, K>(a, o, t, p, count, mind, mins);
  const unsigned m = __ballot_sync(0xffffffffu, open);
  unsigned base = 0;
  if (lane == 0 && m) base = atomicAdd(s.qn, (unsigned)__popc(m));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (open) s.q[base + __popc(m & ((1u << lane) - 1u))] = t | count << 10 | mind << 16 | (unsigned)mins << 22;
  __syncthreads();

  // -- C. the rest of the open walks, dense --------------------------------------
  const int qn = (int)*s.qn;
  for (int qi = t; qi < qn; qi += CT_T) {
    const unsigned e = s.q[qi];  // pixel (10 bits), count and mind (6 each), mins (10)
    const int tp = e & 1023, rq = tp >> 6, cq = tp & 63;
    const int xq = x0 + cq, yq = y0 + rq, pq = yq * W + xq;
    int cnt = (e >> 10) & 63, md = (e >> 16) & 63, ms = e >> 22, jq = CT_BATCH;
    WalkCtx<C> wq;
    walk_ctx<C, K, FUSED>(wq, a, s.pl, s.lut, rq, cq, xq, yq, pq);
    walk_samples<C, SRC, K>(wq, a, s.col, rq * 64 + cq, pq, HW, s.lut, N, jq, cnt, md, ms);
    walk_result<FUSED, K>(a, o, tp, pq, cnt, md, ms);
  }
}

template <int C>
__global__ void __launch_bounds__(CT_T) consensus_kernel(ConsArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const CtShared s = ct_shared<C>(smem, a.N);
  const int x0 = blockIdx.x * CT_W, y0 = blockIdx.y * CT_H;
  ct_replay<C, Consensus::SuBSENSE>(a, s, x0, y0);
  ct_walk<C, false, ColSrc::Shared, Consensus::SuBSENSE>(a, s, WalkOut{nullptr, nullptr}, x0, y0);
}

template <int C>
static int launch_consensus(const ConsArgs& a, cudaStream_t stream) {
  // the dynamic shared memory the largest bank (N = 63) needs, set once
  static const cudaError_t attr = cudaFuncSetAttribute(
      consensus_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, ct_smem_bytes<C>(63));
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.W + CT_W - 1) / CT_W, (a.H + CT_H - 1) / CT_H);
  consensus_kernel<C><<<grid, CT_T, ct_smem_bytes<C>(a.N), stream>>>(a);
  return (int)cudaGetLastError();
}

TT_EXPORT int tt_consensus(const void* plane0, const void* plane1, const void* plane2, void* col0, void* col1,
                           void* col2, void* desc0, void* desc1, void* desc2, const void* ctrl, const void* val0,
                           const void* val1, const void* val2, const void* R, const void* unstable,
                           const void* required, const void* lut_delta, void* count, void* mind, void* mins,
                           void* intra, void* bg_sum, int C, int N, int H, int W, float rel, float div,
                           float hi_const, int min_cd, int desc_off, int row_ext, void* stream_) {
  if (row_ext != 0 && row_ext < 2) return (int)cudaErrorInvalidValue;  // the walk reads rows +/- 2
  if (N < 1 || N > 63) return (int)cudaErrorInvalidValue;             // the log's 6-bit slots
  ConsArgs a;
  a.planes[0] = static_cast<const uint8_t*>(plane0);
  a.planes[1] = static_cast<const uint8_t*>(plane1);
  a.planes[2] = static_cast<const uint8_t*>(plane2);
  void* cols[3] = {col0, col1, col2};
  void* descs[3] = {desc0, desc1, desc2};
  const void* vals[3] = {val0, val1, val2};
  bool aligned = W % 16 == 0;
  for (int c = 0; c < 3; ++c) {
    a.banks.col[c] = static_cast<uint8_t*>(cols[c]);
    a.banks.desc[c] = static_cast<uint16_t*>(descs[c]);
    a.banks.vals[c] = static_cast<const int32_t*>(vals[c]);
    if (c < C) aligned = aligned && (uintptr_t)cols[c] % 16 == 0;
  }
  a.ctrl = static_cast<const int32_t*>(ctrl);
  a.R = static_cast<const float*>(R);
  a.unstable = static_cast<const bool*>(unstable);
  a.required = static_cast<const int32_t*>(required);
  a.lut_delta = static_cast<const int32_t*>(lut_delta);
  a.count = static_cast<int32_t*>(count);
  a.mind = static_cast<int32_t*>(mind);
  a.mins = static_cast<int32_t*>(mins);
  a.intra = static_cast<int32_t*>(intra);
  a.bg_sum = static_cast<int32_t*>(bg_sum);
  a.N = N;
  a.H = H;
  a.W = W;
  a.E = row_ext;
  a.rel = rel;
  a.inv_div = 1.0f / div;  // XLA's f32 reciprocal of the constant divisor
  a.hi = hi_const;
  a.min_cd = min_cd;
  a.desc_off = desc_off;
  a.vec = aligned ? 1 : 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (C == 1) return launch_consensus<1>(a, stream);
  if (C == 3) return launch_consensus<3>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// lobster_kernel: LOBSTER's consensus, one block of CT_T threads per
// CT_H x 64 tile as consensus_kernel. Replaces
// tracking_tpu/ops/pallas_consensus.py:consensus_lobster_pallas
// (_make_lobster_kernel). Steps 1-4 of the header with LOBSTER's threshold
// thr(v) = clip(rint((v*rel + offset) * (1/div)), 0, 255), for the intra and
// the inter descriptors alike, and its fixed sample test (walk_samples): per
// channel cd <= c_sc and dd <= d_sc, where dd is the popcount of (inter-frame
// descriptor XOR the sample's descriptor); for C = 3 also sum(cd) <= c_tot
// and sum(dd) <= d_tot. The walk stops once `req` good samples are counted.
// LOBSTER's pending log is the 3x3-only case of SuBSENSE's, so ct_replay
// replays it as it stands; the kernel writes count, intra and bg_sum.
//
// Bound on the H100: device-memory bytes. At 720p colour bg_sum alone reads
// every colour slot, 96.8 MB (35 x 921,600 px x 3 channels x 1 B): 0.029 ms
// at 3.35 TB/s; with the descriptors of the samples the walk examines, the
// pending log and the output maps, chip_smoke.py counts 0.048 ms on its
// clip. The first design, one thread per pixel in 32 x 8 blocks, reached
// 24.5 % of it (0.196 ms on an H100, PERF.md section 6): its replay wrote
// each colour byte and descriptor word straight to the banks (a partial
// 32-byte sector each), bg_sum read the 35 x C colour bytes back one byte
// load at a time, the 16 LBSP neighbours a channel came as scalar bytes from
// device memory with 2-D clamps, every sample cost a float threshold and 16
// scalar compares a channel with its loads issued after the previous
// sample's test, and a warp walked all 35 samples beside one foreground
// pixel. Here ct_replay stages the tile's colour slots in shared memory by
// cp.async, writes back only the changed sectors and sums bg_sum four pixels
// a word; ct_stage puts the plane tile and LOBSTER's threshold table in
// shared memory; ct_walk takes byte-SIMD descriptors, CT_BATCH samples'
// descriptors in flight and the open walks densely from a shared queue, the
// colours from the shared copy. No R, unstable or requirement map is read,
// and no mind / mins written.
template <int C>
__global__ void __launch_bounds__(CT_T) lobster_kernel(LobsterArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const CtShared s = ct_shared<C>(smem, a.N);
  const int x0 = blockIdx.x * CT_W, y0 = blockIdx.y * CT_H;
  ct_replay<C, Consensus::LOBSTER>(a, s, x0, y0);
  ct_walk<C, false, ColSrc::Shared, Consensus::LOBSTER>(a, s, WalkOut{nullptr, nullptr}, x0, y0);
}

template <int C>
static int launch_lobster(const LobsterArgs& a, cudaStream_t stream) {
  // the dynamic shared memory the largest bank (N = 63) needs, set once
  static const cudaError_t attr = cudaFuncSetAttribute(
      lobster_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, ct_smem_bytes<C>(63));
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.W + CT_W - 1) / CT_W, (a.H + CT_H - 1) / CT_H);
  lobster_kernel<C><<<grid, CT_T, ct_smem_bytes<C>(a.N), stream>>>(a);
  return (int)cudaGetLastError();
}

TT_EXPORT int tt_consensus_lobster(const void* plane0, const void* plane1, const void* plane2, void* col0, void* col1,
                                   void* col2, void* desc0, void* desc1, void* desc2, const void* ctrl,
                                   const void* val0, const void* val1, const void* val2, void* count, void* intra,
                                   void* bg_sum, int C, int N, int H, int W, float rel, float offset, float div,
                                   int c_sc, int d_sc, int c_tot, int d_tot, int req, int row_ext, void* stream_) {
  if (row_ext != 0 && row_ext < 2) return (int)cudaErrorInvalidValue;  // the walk reads rows +/- 2
  if (N < 1 || N > 63) return (int)cudaErrorInvalidValue;             // the log's 6-bit slots
  LobsterArgs a;
  const void* planes[3] = {plane0, plane1, plane2};
  void* cols[3] = {col0, col1, col2};
  void* descs[3] = {desc0, desc1, desc2};
  const void* vals[3] = {val0, val1, val2};
  bool aligned = W % 16 == 0;
  for (int c = 0; c < 3; ++c) {
    a.planes[c] = static_cast<const uint8_t*>(planes[c]);
    a.banks.col[c] = static_cast<uint8_t*>(cols[c]);
    a.banks.desc[c] = static_cast<uint16_t*>(descs[c]);
    a.banks.vals[c] = static_cast<const int32_t*>(vals[c]);
    if (c < C) aligned = aligned && (uintptr_t)cols[c] % 16 == 0;
  }
  a.ctrl = static_cast<const int32_t*>(ctrl);
  a.count = static_cast<int32_t*>(count);
  a.intra = static_cast<int32_t*>(intra);
  a.bg_sum = static_cast<int32_t*>(bg_sum);
  a.N = N;
  a.H = H;
  a.W = W;
  a.E = row_ext;
  a.rel = rel;
  a.offset = offset;
  a.inv_div = 1.0f / div;  // XLA's f32 reciprocal of the constant divisor
  a.c_sc = c_sc;
  a.d_sc = d_sc;
  a.c_tot = c_tot;
  a.d_tot = d_tot;
  a.req = req;
  a.vec = aligned ? 1 : 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (C == 1) return launch_lobster<1>(a, stream);
  if (C == 3) return launch_lobster<3>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// read_walk_kernel: consensus v3's read-only walk, one block of CT_T threads
// per CT_H x 64 tile as consensus_kernel. Replaces
// tracking_tpu/ops/pallas_consensus.py:consensus_read_pallas
// (_make_read_kernel) and, with the same inputs and outputs, the retired v2
// walk attic/pallas_consensus2.py:consensus_walk_pallas. The banks are
// already current (the step applies its slot writes eagerly, in plain torch,
// with frame-global slots), so there is no replay, no bg_sum and no write:
// steps 3-4 of consensus_kernel on const banks. `required` arrives
// ROI-zeroed, so walk_req<false> serves as it is. The v2 TPU kernel fetched
// slot groups on demand so that converged tiles skip the rest; a walk that
// reads a pixel's slots only as it reaches them does that here, so one
// kernel stands for both TPU kernels.
//
// Bound on the H100: device-memory bytes - the frame, R, unstable and
// required (C + 9 B/px), the samples each walk examines (3 B per channel)
// and the 3 + C int32 maps written: 0.022 ms at 720p colour on
// chip_smoke.py's clip (4.9 samples a pixel). The first design, one thread
// per pixel in 32 x 8 blocks, reached 6.5 % of it (0.34 ms on an H100,
// PERF.md section 6): 16 byte loads of LBSP neighbours a channel from device
// memory, 16 scalar compares after a float threshold for every descriptor of
// every sample, and a warp walking all 50 samples beside one foreground
// pixel. Here ct_stage puts the tile's planes and the threshold table in
// shared memory and ct_walk runs consensus_kernel's phases B and C: byte-SIMD
// descriptors, CT_BATCH samples' loads in flight, the open walks packed
// densely from a shared queue. The colours come from the banks with the
// descriptors (ColSrc::Banks), a batch's four bytes of a channel packed in
// one register: the walk examines about 5 of the 50 slots, so staging the
// tile's colour slots would read 138 MB for 13 MB of need. ptxas (CUDA 12.8,
// sm_90a): <3> 64 registers, <1> 40, no stack frame, no spills (chip_smoke.py
// phase 2 fails on either). Phase C walks of 6, 8 or 12 samples a batch took
// more registers and were slower (timed beside this one, not committed).
template <int C>
__global__ void __launch_bounds__(CT_T) read_walk_kernel(ReadArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const CtShared s = ct_shared<C>(smem, 0);  // no colour copy
  const int x0 = blockIdx.x * CT_W, y0 = blockIdx.y * CT_H;
  ct_stage<C, Consensus::SuBSENSE>(a, s, threadIdx.x, x0, y0, a.H, a.W, a.E);
  if (threadIdx.x == 0) *s.qn = 0;
  __syncthreads();
  ct_walk<C, false, ColSrc::Banks, Consensus::SuBSENSE>(a, s, WalkOut{nullptr, nullptr}, x0, y0);
}

TT_EXPORT int tt_consensus_read(const void* plane0, const void* plane1, const void* plane2, const void* col0,
                                const void* col1, const void* col2, const void* desc0, const void* desc1,
                                const void* desc2, const void* R, const void* unstable, const void* required,
                                const void* lut_delta, void* count, void* mind, void* mins, void* intra, int C, int N,
                                int H, int W, float rel, float div, float hi_const, int min_cd, int desc_off,
                                int row_ext, void* stream_) {
  if (row_ext != 0 && row_ext < 2) return (int)cudaErrorInvalidValue;  // the walk reads rows +/- 2
  if (N < 1 || N > 63) return (int)cudaErrorInvalidValue;             // the queue's 6-bit counts
  ReadArgs a{};
  const void* planes[3] = {plane0, plane1, plane2};
  const void* cols[3] = {col0, col1, col2};
  const void* descs[3] = {desc0, desc1, desc2};
  for (int c = 0; c < 3; ++c) {
    a.planes[c] = static_cast<const uint8_t*>(planes[c]);
    a.banks.col[c] = static_cast<const uint8_t*>(cols[c]);
    a.banks.desc[c] = static_cast<const uint16_t*>(descs[c]);
  }
  a.R = static_cast<const float*>(R);
  a.unstable = static_cast<const bool*>(unstable);
  a.required = static_cast<const int32_t*>(required);
  a.lut_delta = static_cast<const int32_t*>(lut_delta);
  a.count = static_cast<int32_t*>(count);
  a.mind = static_cast<int32_t*>(mind);
  a.mins = static_cast<int32_t*>(mins);
  a.intra = static_cast<int32_t*>(intra);
  a.N = N;
  a.H = H;
  a.W = W;
  a.E = row_ext;
  a.rel = rel;
  a.inv_div = 1.0f / div;  // XLA's f32 reciprocal of the constant divisor
  a.hi = hi_const;
  a.min_cd = min_cd;
  a.desc_off = desc_off;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  dim3 grid((W + CT_W - 1) / CT_W, (H + CT_H - 1) / CT_H);
  if (C == 1) {
    read_walk_kernel<1><<<grid, CT_T, ct_smem_bytes<1>(0), stream>>>(a);
  } else if (C == 3) {
    read_walk_kernel<3><<<grid, CT_T, ct_smem_bytes<3>(0), stream>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fused_kernel: SuBSENSE's whole step, one block of CT_T threads per
// CT_H x 64 tile as consensus_kernel. Replaces
// tracking_tpu/ops/pallas_consensus.py:consensus_feedback_pallas
// (_make_fused_kernel). Phases:
//   A. ct_replay: the old log into the banks (colours through the tile's
//      shared copy, written back by changed sector; descriptors straight)
//      and bg_sum, the same code as consensus_kernel's;
//   B-C. ct_walk with the ROI-zeroed requirement: the walk stops at it, while
//      the feedback divides by the true one (a zero there would make 0/0 on
//      the border). The results stay in shared memory (WalkOut), not in
//      global maps;
//   D. after a __syncthreads each pixel's own thread reads its walk results
//      back, adopts this frame as the last one on frame 0 (t is read on the
//      card), reads its feedback state (coalesced along the tile's 64
//      columns), runs feedback_core (feedback.cuh) and writes the flags word
//      (bit 0 is_fg, 1 unstable, 2 nz, 3 curr_blink, 4 blinks_pre), the next
//      frame's pending log and eight f32 maps (mean_last, dmin_lt, dmin_st,
//      raw_lt, raw_st, T, v, R).
//
// The pending log is double-buffered: phase A reads the OLD pend_vals of up
// to 24 neighbours, some in other blocks, while phase D writes the NEW log,
// so the new log goes to separate output maps (written in place it would
// race with the neighbours' spread picks). Only the banks are updated in
// place: a pixel's writes touch only its own slots. The TPU kernel aliases
// only the banks too. The sharded path refuses the fused step, so there is
// no slab mode (E = 0).
//
// Bound on the H100: device-memory bytes - consensus_kernel's plus about
// 100 B/px of feedback state (9 f32 maps in, 8 out, 16 B of random bits,
// five mask bytes, the last frame's colour and descriptors, the flags word
// and the new log); chip_smoke.py counts them on its run's data. The
// earlier design, one thread per pixel with the slot writes straight to the
// banks, a byte-at-a-time bg_sum and the scalar walk, paid the partial-sector
// slot writes and scalar descriptor steps that consensus_kernel's phases remove (0.78 ms against 0.37 on an
// H100 at 720p colour, PERF.md section 6).
struct FusedArgs {
  ConsArgs cons;  // planes, banks, old log, R, unstable, the true requirement, bg_sum
  const uint8_t* last_color[3];
  const uint16_t* last_desc[3];
  const int32_t* bits;
  const uint8_t* masks[5];  // last_final, blinks_old, last_blink_mask, last_raw, last_dil_inv
  const float* f32_in[9];   // mean_last, dmin_lt, dmin_st, raw_lt, raw_st, final_lt, final_st, T, v
  const float* fscal[4];    // a_lt, a_st, lr_lower, lr_upper (0-d)
  const int32_t* iscal[2];  // cooldown, t (0-d)
  int32_t* out_i;           // flags, pend_ctrl, pend_vals x C, bg_sum x C
  float* out_f;             // mean_last, dmin_lt, dmin_st, raw_lt, raw_st, T, v, R
};

// NB3 offset index (0..7) -> its index in the 5x5 order (ops/consensus.py NB3_IN_NB5)
__constant__ int8_t kNb3InNb5[8] = {6, 7, 8, 11, 12, 15, 16, 17};

template <int C>
__host__ __device__ constexpr int fused_smem_bytes(int N) {
  return ct_smem_bytes<C>(N) + CT_T * 4 * (1 + C);  // + WalkOut
}

template <int C>
__global__ void __launch_bounds__(CT_T) fused_kernel(FusedArgs a, bool use3x3_global, FbConsts k) {
  extern __shared__ __align__(16) uint8_t smem[];
  const ConsArgs& ca = a.cons;
  const CtShared s = ct_shared<C>(smem, ca.N);
  WalkOut o;
  o.res = reinterpret_cast<uint32_t*>(smem + ct_smem_bytes<C>(ca.N));
  o.pv = o.res + CT_T;
  const int x0 = blockIdx.x * CT_W, y0 = blockIdx.y * CT_H;
  ct_replay<C, Consensus::SuBSENSE>(ca, s, x0, y0);
  ct_walk<C, true, ColSrc::Shared, Consensus::SuBSENSE>(ca, s, o, x0, y0);
  __syncthreads();

  // -- D. the feedback, each pixel on its own thread --------------------------------
  const int t = threadIdx.x;
  const int H = ca.H, W = ca.W;
  const int x = x0 + (t & 63), y = y0 + (t >> 6);
  if (x >= W || y >= H) return;
  const size_t HW = (size_t)H * W;
  const int p = y * W + x;
  const uint32_t res = o.res[t];
  const int count = res & 255, mind = (res >> 8) & 255, mins = res >> 16;
  int px[C], intra[C], lc[C], ld[C];
  const bool first = *a.iscal[1] == 0;  // frame 0 adopts this frame as the last one
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const uint32_t v = o.pv[c * CT_T + t];
    px[c] = v & 255;
    intra[c] = v >> 8;
    lc[c] = first ? px[c] : (int)a.last_color[c][p];
    ld[c] = first ? intra[c] : (int)a.last_desc[c][p];
  }
  int bits[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) bits[i] = a.bits[i * HW + p];
  FbState st;
  st.mean_last = a.f32_in[0][p];
  st.dmin_lt = a.f32_in[1][p];
  st.dmin_st = a.f32_in[2][p];
  st.raw_lt = a.f32_in[3][p];
  st.raw_st = a.f32_in[4][p];
  st.final_lt = a.f32_in[5][p];
  st.final_st = a.f32_in[6][p];
  st.T = a.f32_in[7][p];
  st.v = a.f32_in[8][p];
  st.R = ca.R[p];
  st.last_final = a.masks[0][p] != 0;
  st.blinks_old = a.masks[1][p] != 0;
  st.last_blink_mask = a.masks[2][p] != 0;
  st.last_raw = a.masks[3][p] != 0;
  st.last_dil_inv = a.masks[4][p] != 0;
  FbScalars sc;
  sc.a_lt = *a.fscal[0];
  sc.a_st = *a.fscal[1];
  sc.lr_lower = *a.fscal[2];
  sc.lr_upper = *a.fscal[3];
  sc.cooldown = *a.iscal[0];
  const bool roi = y >= 2 && y <= H - 3 && x >= 2 && x <= W - 3;
  const FbOut fb = feedback_core<C>(count, mind, mins, ca.required[p], roi, px, intra, lc, ld, bits, st, sc, ca.N,
                                    use3x3_global, k);

  a.out_i[p] = (int)fb.is_fg | ((int)fb.unstable << 1) | ((int)fb.nz << 2) | ((int)fb.curr_blink << 3) |
               ((int)fb.blinks_pre << 4);
  a.out_i[HW + p] = (int)fb.upd1 | (fb.slot1 << 1) | ((int)kNb3InNb5[fb.o3] << 7) | (fb.o5 << 12) |
                    (fb.slot3 << 17) | (fb.slot5 << 23);
  const int fires = (int)fb.fire3 | ((int)fb.fire5 << 1);
#pragma unroll
  for (int c = 0; c < C; ++c) a.out_i[(2 + c) * HW + p] = px[c] | (intra[c] << 8) | (c == 0 ? fires << 24 : 0);
  const float f32_out[8] = {fb.mean_last, fb.dmin_lt, fb.dmin_st, fb.raw_lt, fb.raw_st, fb.T, fb.v, fb.R};
#pragma unroll
  for (int i = 0; i < 8; ++i) a.out_f[i * HW + p] = f32_out[i];
}

template <int C>
static int launch_fused(const FusedArgs& a, bool use3x3_global, const FbConsts& k, cudaStream_t stream) {
  // the dynamic shared memory the largest bank (N = 63) needs, set once
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, fused_smem_bytes<C>(63));
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((a.cons.W + CT_W - 1) / CT_W, (a.cons.H + CT_H - 1) / CT_H);
  fused_kernel<C><<<grid, CT_T, fused_smem_bytes<C>(a.cons.N), stream>>>(a, use3x3_global, k);
  return (int)cudaGetLastError();
}

// ptrs: the 46 device pointers in the order of ops/consensus.py:consensus_feedback
// (planes x3, col x3, desc x3, pend_ctrl, pend_vals x3, R, unstable,
// required, lut_delta, last_color x3, last_desc x3, bits, masks x5, f32 state
// x9, a_lt, a_st, lr_lower, lr_upper, cooldown, t, int outputs, f32
// outputs); kc: the 12 FbConsts in field order.
TT_EXPORT int tt_consensus_feedback(void* const* ptrs, const float* kc, int C, int N, int H, int W, float rel,
                                    float div, float hi_const, int min_cd, int desc_off, int use3x3_global,
                                    void* stream_) {
  if (N < 1 || N > 63) return (int)cudaErrorInvalidValue;  // the log's 6-bit slots
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const size_t HW = (size_t)H * W;
  FusedArgs a;
  ConsArgs& ca = a.cons;
  int i = 0;
  for (int c = 0; c < 3; ++c) ca.planes[c] = static_cast<const uint8_t*>(ptrs[i++]);
  bool aligned = W % 16 == 0;
  for (int c = 0; c < 3; ++c) {
    ca.banks.col[c] = static_cast<uint8_t*>(ptrs[i++]);
    if (c < C) aligned = aligned && (uintptr_t)ca.banks.col[c] % 16 == 0;
  }
  for (int c = 0; c < 3; ++c) ca.banks.desc[c] = static_cast<uint16_t*>(ptrs[i++]);
  ca.ctrl = static_cast<const int32_t*>(ptrs[i++]);
  for (int c = 0; c < 3; ++c) ca.banks.vals[c] = static_cast<const int32_t*>(ptrs[i++]);
  ca.R = static_cast<const float*>(ptrs[i++]);
  ca.unstable = static_cast<const bool*>(ptrs[i++]);
  ca.required = static_cast<const int32_t*>(ptrs[i++]);
  ca.lut_delta = static_cast<const int32_t*>(ptrs[i++]);
  for (int c = 0; c < 3; ++c) a.last_color[c] = static_cast<const uint8_t*>(ptrs[i++]);
  for (int c = 0; c < 3; ++c) a.last_desc[c] = static_cast<const uint16_t*>(ptrs[i++]);
  a.bits = static_cast<const int32_t*>(ptrs[i++]);
  for (int m = 0; m < 5; ++m) a.masks[m] = static_cast<const uint8_t*>(ptrs[i++]);
  for (int f = 0; f < 9; ++f) a.f32_in[f] = static_cast<const float*>(ptrs[i++]);
  for (int f = 0; f < 4; ++f) a.fscal[f] = static_cast<const float*>(ptrs[i++]);
  for (int f = 0; f < 2; ++f) a.iscal[f] = static_cast<const int32_t*>(ptrs[i++]);
  a.out_i = static_cast<int32_t*>(ptrs[i++]);
  a.out_f = static_cast<float*>(ptrs[i++]);
  ca.count = ca.mind = ca.mins = ca.intra = nullptr;  // the walk's results stay in shared memory
  ca.bg_sum = a.out_i + (2 + C) * HW;
  ca.N = N;
  ca.H = H;
  ca.W = W;
  ca.E = 0;
  ca.rel = rel;
  ca.inv_div = 1.0f / div;  // XLA's f32 reciprocal of the constant divisor
  ca.hi = hi_const;
  ca.min_cd = min_cd;
  ca.desc_off = desc_off;
  ca.vec = aligned ? 1 : 0;
  FbConsts k = {kc[0], kc[1], kc[2], kc[3], kc[4], kc[5], kc[6], kc[7], kc[8], kc[9], kc[10], kc[11]};
  if (C == 1) return launch_fused<1>(a, use3x3_global != 0, k, stream);
  if (C == 3) return launch_fused<3>(a, use3x3_global != 0, k, stream);
  return (int)cudaErrorInvalidValue;
}
