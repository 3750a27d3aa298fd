// SuBSENSE's feedback and update-decision stage for one pixel: the device
// counterpart of ops/feedback.py (derive_draws and _core), statement by
// statement, which is itself tracking_tpu/ops/pallas_feedback.py:93-225.
// The fused whole-step kernel (consensus.cu:fused_kernel) runs it in its
// phase D on the walk's results, one thread per pixel.
//
// Float exactness against the plain version (and through it the JAX
// package): the file builds with -fmad=false and without fast math, so
// every product and sum rounds on its own and every '/' is an IEEE
// division. A division by a constant is XLA's product with the f32
// reciprocal (1/max_color, 1/max_desc); the true divisions stay divisions:
// (required - count) / required, t_incr / (dmin_max * v),
// (v * t_decr) / dmin_max and r_var / v. The constants arrive as the f32
// rounding of the Python doubles the plain version uses (FbConsts).
// torch.minimum / maximum propagate NaN; tmin / tmax do the same.
#pragma once

#include <stdint.h>

struct FbConsts {
  float t_incr, t_decr, t_lower, v_incr, v_decr, v_decr_4, v_decr_2, r_var;
  float rdist_min, ratio_min, ghost_s_min, ghost_d_max;
};

// the frame scalars: a_lt, a_st, lr_lower, lr_upper (f32) and cooldown (int)
struct FbScalars {
  float a_lt, a_st, lr_lower, lr_upper;
  int cooldown;
};

// one pixel's carried feedback state and masks (masks nonzero = set)
struct FbState {
  float mean_last, dmin_lt, dmin_st, raw_lt, raw_st, final_lt, final_st, R, T, v;
  bool last_final, blinks_old, last_blink_mask, last_raw, last_dil_inv;
};

struct FbOut {
  bool is_fg, unstable, nz, curr_blink, blinks_pre, upd1, fire3, fire5;
  int slot1, o3, o5, slot3, slot5;
  float mean_last, dmin_lt, dmin_st, raw_lt, raw_st, T, v, R;
};

__device__ __forceinline__ float tmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float tmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ int fb_field(int b, int lo, int nbits) { return (int)(((unsigned)b >> lo) & ((1u << nbits) - 1u)); }

// derive_draws: 4 random words -> two 23-bit uniforms and 16-bit fixed-point
// slot / offset draws; mutually exclusive decisions share a field.
__device__ __forceinline__ void derive_draws(const int bits[4], int N, float& u1, float& u_nb, int& slot1, int& slotn,
                                             int& o3, int& o5) {
  u1 = (float)fb_field(bits[0], 9, 23) * 0x1p-23f;
  u_nb = (float)fb_field(bits[1], 9, 23) * 0x1p-23f;
  slot1 = (fb_field(bits[2], 0, 16) * N) >> 16;
  slotn = (fb_field(bits[2], 16, 16) * N) >> 16;
  o3 = (fb_field(bits[3], 0, 16) * 8) >> 16;
  o5 = (fb_field(bits[3], 16, 16) * 24) >> 16;
}

// _core for one pixel. px / intra: this frame's values and descriptors;
// lc / ld: the last frame's (already adopted on frame 0).
template <int C>
__device__ __forceinline__ FbOut feedback_core(int count, int mind, int mins, int required, bool roi, const int px[C],
                                               const int intra[C], const int lc[C], const int ld[C],
                                               const int bits[4], const FbState& s, const FbScalars& sc, int N,
                                               bool use3x3_global, const FbConsts& k) {
  FbOut o;
  const float inv_max_color = 1.0f / (float)(255 * C);
  const float inv_max_desc = 1.0f / (float)(16 * C);
  const float one_lt = 1.0f - sc.a_lt, one_st = 1.0f - sc.a_st;

  const bool is_fg = (count < required) && roi;
  const bool is_bg = !is_fg && roi;

  const bool unstable = (s.R > k.rdist_min) || ((s.raw_lt - s.final_lt) > k.ratio_min) ||
                        ((s.raw_st - s.final_st) > k.ratio_min);

  int color_ld = 0, desc_ld = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    color_ld += abs(lc[c] - px[c]);
    desc_ld += __popc((ld[c] ^ intra[c]) & 0xFFFF);
  }
  const float nld = ((float)color_ld * inv_max_color + (float)desc_ld * inv_max_desc) * 0.5f;
  const float mean_last = s.mean_last * one_st + nld * sc.a_st;

  const float nmd_base = ((float)mins * inv_max_color + (float)mind * inv_max_desc) * 0.5f;
  const float nmd_fg = tmin(1.0f, nmd_base + (float)(required - count) / (float)required);
  const float nmd = is_fg ? nmd_fg : nmd_base;
  const float dmin_lt = s.dmin_lt * one_lt + nmd * sc.a_lt;
  const float dmin_st = s.dmin_st * one_st + nmd * sc.a_st;
  const float fg_f = is_fg ? 1.0f : 0.0f;
  const float raw_lt = s.raw_lt * one_lt + fg_f * sc.a_lt;
  const float raw_st = s.raw_st * one_st + fg_f * sc.a_st;

  float u1, u_nb;
  int slot1, slotn, o3, o5;
  derive_draws(bits, N, u1, u_nb, slot1, slotn, o3, o5);
  const float lr_f = tmax(ceilf(s.T), 1.0f);
  const bool upd_cd = is_fg && (sc.cooldown > 0) && (u1 * k.t_lower < 1.0f);
  const bool upd_self = is_bg && (u1 * lr_f < 1.0f);

  const bool use3_src = use3x3_global && !unstable;
  const bool ghost = (raw_st > k.ghost_s_min) && (mean_last < k.ghost_d_max);
  const float rate5_f = floorf(lr_f * 0.5f) + 1.0f;
  const float lower_f = tmax(sc.lr_lower, 1.0f);
  const bool fire_lo = ghost && (u_nb * lower_f < 1.0f);
  o.fire3 = is_bg && use3_src && ((u_nb * lr_f < 1.0f) || fire_lo);
  o.fire5 = is_bg && !use3_src && ((u_nb * rate5_f < 1.0f) || fire_lo);

  const float dmin_max = tmax(dmin_lt, dmin_st);
  const float dmin_min = tmin(dmin_lt, dmin_st);
  const bool t_up = s.last_final || ((dmin_min < k.ratio_min) && is_fg);
  const float T_inc = s.T + k.t_incr / (dmin_max * s.v);
  const float T_dec = s.T - (s.v * k.t_decr) / dmin_max;
  float T = t_up ? (s.T < sc.lr_upper ? T_inc : s.T) : (s.T > sc.lr_lower ? T_dec : s.T);
  T = tmin(tmax(T, sc.lr_lower), sc.lr_upper);

  const bool v_up = (dmin_max > k.ratio_min) && s.blinks_old;
  const float v_dec_amt = s.last_final ? k.v_decr_4 : (unstable ? k.v_decr_2 : k.v_decr);
  const float v_decd = tmax(s.v - v_dec_amt, k.v_decr);
  const float v = v_up ? s.v + k.v_incr : (s.v > k.v_decr ? v_decd : s.v);

  float r_limit = 1.0f + dmin_min * 2.0f;
  r_limit = r_limit * r_limit;
  const float R = s.R < r_limit ? s.R + (v - k.v_decr) * k.r_var : tmax(s.R - k.r_var / v, 1.0f);

  int nz_bits = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) nz_bits += __popc(intra[c] & 0xFFFF);

  o.is_fg = is_fg;
  o.unstable = unstable;
  o.nz = nz_bits >= (C == 1 ? 2 : 4);
  o.curr_blink = is_fg != s.last_raw;
  o.blinks_pre = (o.curr_blink || s.last_blink_mask) && s.last_dil_inv;
  o.upd1 = upd_cd || upd_self;
  o.slot1 = slot1;  // upd_cd and the self update share the slot draw
  o.o3 = o3;
  o.o5 = o5;
  o.slot3 = slotn;
  o.slot5 = slotn;
  o.mean_last = mean_last;
  o.dmin_lt = dmin_lt;
  o.dmin_st = dmin_st;
  o.raw_lt = raw_lt;
  o.raw_st = raw_st;
  o.T = T;
  o.v = v;
  o.R = R;
  return o;
}
