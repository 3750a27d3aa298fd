// texture_prox_cur: DPTexture's windowed LBP histograms and the histogram
// intersection with the model.
//
// Replaces tracking_tpu/ops/pallas_texture.py:texture_prox_cur_pallas. Per
// pixel and channel: count the 121 codes of the 11x11 window into 64 bins
// (positions outside the image carry no code and count nothing; a code
// >= 64 counts nothing), write the counts to `cur`, and add min(model, cur)
// over the bins into `prox`. All integer, so exact.
//
// Bound on the H100: device-memory bytes. At 720p the model is read once
// (3 x 64 x 921,600 B = 176.9 MB), `cur` written once (176.9 MB), the codes
// read (2.8 MB) and `prox` written (3.7 MB): 356.6 MB, 0.106 ms at
// 3.35 TB/s. One thread a pixel, with 121 shared-memory byte increments
// and 128 one-byte global accesses a channel, is bound by its load and
// store instructions, not by bytes. Here, as in the Pallas kernel, counts
// for 4 bins or 4 pixels ride one 32-bit word as byte lanes (a count is at
// most 121 < 128: no carry, and the high bit is free for the borrow-free
// byte min):
//   - a block owns a tile of 8 rows x 128 columns and loops over the
//     channels, so `prox` needs no atomics in device memory. It stages the
//     tile's codes with the 5-pixel halo in shared memory, 255 outside the
//     image (plain byte loads: the halo starts 5 bytes before an aligned
//     column, which cp.async cannot copy; the codes are < 1 % of the bytes);
//   - per column of the tile and halo, the 11-row vertical count of each
//     bin lives in shared memory as bytes, bin-major (`vc[bin][column]`).
//     Moving down a row costs one byte increment and one decrement a
//     column;
//   - a lane owns 4 adjacent pixels of a row, a warp 16 of the 64 bins.
//     One bin's 11-column sums for the 4 pixels come from 4 shared words by
//     funnel shifts and adds (prefix doubling: 2, 4, 8 + 2 + 1 columns), in
//     bin-major byte lanes: the layout of `model` and `cur`, so each is one
//     4-byte access a lane and 128 contiguous bytes a warp, with no
//     transpose;
//   - the byte min is the borrow-free SWAR min of pallas_texture.py:86-92,
//     with the model's high bit OR-ed into the test (any u8 model is
//     exact); the sums go to shared memory as 16-bit pairs (at most
//     C x 64 x 121 < 65536 for C <= 8, checked below).
// Ragged widths (W % 4 != 0) take byte accesses for model, cur and prox.
// ptxas (CUDA 12.8, sm_90a): texture_kernel<0|1> 56 registers, 13,856 B of
// static shared memory, no stack frame, no spills (chip_smoke.py phase 2
// fails on either): at 720p 900 blocks of 128 threads, one wave. Tiles of 4
// or 16 rows, streaming cache hints on model and cur, and loading the next
// row's model words during this row's counts were each slower.
#include "common.cuh"

namespace {

constexpr int kBins = 64;
constexpr int kR = 5;                    // window radius: 11 x 11
constexpr int kTW = 128;                 // tile columns: 32 lanes x 4 pixels
constexpr int kTH = 8;                   // tile rows
constexpr int kWarps = 4;                // a warp takes 16 of the 64 bins
constexpr int kThreads = 32 * kWarps;
constexpr int kWB = kBins / kWarps;
constexpr int kCols = kTW + 2 * kR;      // tile columns with the halo (138)
constexpr int kSW = 144;                 // shared row stride: kCols padded to 16 B
constexpr int kRows = kTH + 2 * kR;      // staged code rows
constexpr int kMaxC = 8;                 // 16-bit prox lanes: kMaxC x 64 x 121 < 65536

struct Smem {
  uint8_t vc[kBins][kSW];      // vertical 11-row counts, per bin and column
  uint8_t code[kRows][kSW];    // the tile's codes with the halo, 255 outside
  uint32_t prox[kTH][2][32];   // per row and lane, pixels (0, 2) and (1, 3) as 16-bit pairs
};

// The 11-column sums of one bin's vertical counts for a lane's 4 pixels:
// bytes v[4l .. 4l + 13] of the row, as 4 byte lanes (pixel k = lane k).
__device__ __forceinline__ uint32_t win11(const uint8_t* row, int lane) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + lane;
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
  const uint32_t a0 = w0 + __funnelshift_r(w0, w1, 8);  // 2 columns, bytes 0-11
  const uint32_t a1 = w1 + __funnelshift_r(w1, w2, 8);
  const uint32_t a2 = w2 + __funnelshift_r(w2, w3, 8);
  const uint32_t q0 = a0 + __funnelshift_r(a0, a1, 16);  // 4 columns, bytes 0-7
  const uint32_t q1 = a1 + __funnelshift_r(a1, a2, 16);
  return q0 + q1 + a2 + __funnelshift_r(w2, w3, 16);  // 8 + 2 + 1 columns
}

// Byte-wise min(model, cnt) for cnt bytes <= 127: a lane takes cnt where
// model >= cnt, i.e. where (model | 0x80) - cnt keeps its high bit (no
// borrow) or model's own high bit is set.
__device__ __forceinline__ uint32_t min_bytes(uint32_t model, uint32_t cnt) {
  const uint32_t d = (model | 0x80808080u) - cnt;
  const uint32_t ge = ((d | model) >> 7) & 0x01010101u;
  const uint32_t msk = ge * 0xFFu;
  return (cnt & msk) | (model & ~msk);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) texture_kernel(const uint8_t* __restrict__ codes,
                                                           const uint8_t* __restrict__ model,
                                                           int32_t* __restrict__ prox, uint8_t* __restrict__ cur,
                                                           int C, int H, int W) {
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx0 = blockIdx.x * kTW, ty0 = blockIdx.y * kTH;
  const int x0 = tx0 + 4 * lane;
  const size_t HW = (size_t)H * W;
  for (int i = tid; i < kTH * 2 * 32; i += kThreads) (&sm.prox[0][0][0])[i] = 0u;

  for (int c = 0; c < C; ++c) {
    const uint8_t* cp = codes + (size_t)c * HW;
    for (int i = tid; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, col = i - r * kCols;
      const int y = ty0 - kR + r, x = tx0 - kR + col;
      sm.code[r][col] = (y >= 0 && y < H && x >= 0 && x < W) ? cp[(size_t)y * W + x] : (uint8_t)255;
    }
    uint4* vz = reinterpret_cast<uint4*>(&sm.vc[0][0]);
    for (int i = tid; i < kBins * kSW / 16; i += kThreads) vz[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    // the window above the first row; a column has one owner thread
    for (int col = tid; col < kCols; col += kThreads)
      for (int r = 0; r < 2 * kR; ++r) {
        const int code = sm.code[r][col];
        if (code < kBins) ++sm.vc[code][col];
      }

    const size_t plane0 = ((size_t)c * kBins + warp * kWB) * HW;
    for (int r = 0; r < kTH; ++r) {
      const int y = ty0 + r;
      const bool live = y < H && x0 < W;
      const size_t at = plane0 + (size_t)y * W + x0;
      uint32_t mw[kWB];  // this row's model words, in flight across the barrier
#pragma unroll
      for (int b = 0; b < kWB; ++b) {
        mw[b] = 0u;
        if (!live) continue;
        const uint8_t* mp = model + at + (size_t)b * HW;
        if (VEC) {
          mw[b] = __ldg(reinterpret_cast<const uint32_t*>(mp));
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (x0 + k < W) mw[b] |= (uint32_t)__ldg(mp + k) << (8 * k);
        }
      }
      for (int col = tid; col < kCols; col += kThreads) {  // slide the window down to row r
        if (r > 0) {
          const int out = sm.code[r - 1][col];
          if (out < kBins) --sm.vc[out][col];
        }
        const int in = sm.code[r + 2 * kR][col];
        if (in < kBins) ++sm.vc[in][col];
      }
      __syncthreads();
      if (live) {
        uint32_t acc_e = 0u, acc_o = 0u;
#pragma unroll
        for (int b = 0; b < kWB; ++b) {
          const uint32_t cnt = win11(sm.vc[warp * kWB + b], lane);
          uint8_t* op = cur + at + (size_t)b * HW;
          if (VEC) {
            *reinterpret_cast<uint32_t*>(op) = cnt;
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (x0 + k < W) op[k] = (uint8_t)(cnt >> (8 * k));
          }
          const uint32_t mn = min_bytes(mw[b], cnt);
          acc_e += mn & 0x00FF00FFu;
          acc_o += (mn >> 8) & 0x00FF00FFu;
        }
        atomicAdd(&sm.prox[r][0][lane], acc_e);
        atomicAdd(&sm.prox[r][1][lane], acc_o);
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < kTH * 32; i += kThreads) {
    const int r = i >> 5, l = i & 31;
    const int y = ty0 + r, x = tx0 + 4 * l;
    if (y >= H || x >= W) continue;
    const uint32_t e = sm.prox[r][0][l], o = sm.prox[r][1][l];
    const int v[4] = {(int)(e & 0xFFFFu), (int)(o & 0xFFFFu), (int)(e >> 16), (int)(o >> 16)};
    int32_t* pp = prox + (size_t)y * W + x;
    if (VEC) {
      *reinterpret_cast<int4*>(pp) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x + k < W) pp[k] = v[k];
    }
  }
}

}  // namespace

TT_EXPORT int tt_texture_prox_cur(const void* codes, const void* model, void* prox, void* cur, int C, int H, int W,
                                  void* stream_) {
  if (C > kMaxC) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const dim3 grid(tt_blocks(W, kTW), tt_blocks(H, kTH));
  const uint8_t* cd = static_cast<const uint8_t*>(codes);
  const uint8_t* md = static_cast<const uint8_t*>(model);
  int32_t* pd = static_cast<int32_t*>(prox);
  uint8_t* od = static_cast<uint8_t*>(cur);
  if (W % 4 == 0)
    texture_kernel<true><<<grid, kThreads, 0, stream>>>(cd, md, pd, od, C, H, W);
  else
    texture_kernel<false><<<grid, kThreads, 0, stream>>>(cd, md, pd, od, C, H, W);
  return (int)cudaGetLastError();
}
