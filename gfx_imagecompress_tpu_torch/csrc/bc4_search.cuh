// Scalar-ramp (BC4 / BC3-alpha / BC5) search for one 4x4 block.
//
// Replaces the Pallas body gfx_imagecompress_tpu/kernels/bc4_pallas.py:
// _bc4_search (and _fit_ramp, _sweep, _sorted_rows, _pack_dxt5 under it).
// The plain PyTorch version is kernels/bc4.py:_bc4_search; this file does
// the same float32 operations in the same order (build with -fmad=false,
// no fast math), keeps the candidate order (first wins on equality) and sums
// the 16 pixels left to right, so both agree bit for bit.
//
// Bound: operations. A block is 64 bytes in and 12 bytes out against a few
// tens of thousands of f32/i32 operations, so the pixels of a block stay in
// the registers of the thread that searches them and nothing but the packed
// words and the error is written. Invalid hill-climb candidates (wrong
// endpoint order for the ramp family) are skipped per thread instead of being
// computed and masked as the row-vector version must.
//
// The search is two independent families, which meet only at the pick
// (bc4_pick): the 8-point ramp (bc4_family8: fit, min/max race, hill climb)
// and the 6-point ramp (bc4_family6: fit, sorting network, 9 trimmed seeds,
// hill climb). K1b runs each family whole on one thread, in a warp of its
// own (csrc/bc23_group.cuh). K2a and K2b deal the same search's seeds and
// climb candidates to a group of lanes (csrc/bc45_group.cuh) and share the
// pieces below: the palette, the least-squares solve, the sorting network,
// the pick, the nearest entry and the pack.
#pragma once
#include "bcx_common.cuh"

namespace bcx {

// clip(round-half-even(x), 0, 255) as int
__device__ __forceinline__ int round_u8(float x) {
  return (int)fminf(fmaxf(rintf(x), 0.0f), 255.0f);
}

// Exact integer ramp of the decoder (decode/bcn.py:bc4_palette) as floats;
// the 6-point family pads the literal 0 and 255 slots.
template <bool EIGHT>
__device__ __forceinline__ void bc4_palette(int a0, int a1, float (&pal)[8]) {
  pal[0] = (float)a0;
  pal[1] = (float)a1;
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    int v;
    if (EIGHT) v = ((8 - i) * a0 + (i - 1) * a1 + 3) / 7;
    else if (i < 6) v = ((6 - i) * a0 + (i - 1) * a1 + 2) / 5;
    else v = (i == 6) ? 0 : 255;
    pal[i] = (float)v;
  }
}

// Sum over the pixels of the squared distance to the nearest ramp entry.
template <bool EIGHT>
__device__ __forceinline__ float bc4_assign_err(const float (&vals)[16], int a0, int a1) {
  float pal[8];
  bc4_palette<EIGHT>(a0, a1, pal);
  float sum = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    float d = vals[p] - pal[0];
    float best = d * d;
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      d = vals[p] - pal[k];
      best = fminf(best, d * d);
    }
    sum = (p == 0) ? best : sum + best;
  }
  return sum;
}

// Nearest ramp entry of the value v (first wins on equality).
__device__ __forceinline__ int bc4_nearest(float v, const float (&pal)[8]) {
  float d = v - pal[0];
  float best = d * d;
  int bi = 0;
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    d = v - pal[k];
    d = d * d;
    if (d < best) { best = d; bi = k; }
  }
  return bi;
}

// The 2x2 normal equations of a least-squares round; a singular system
// keeps the endpoints.
__device__ __forceinline__ void bc4_solve(float q00, float q01, float q11, float b0, float b1,
                                          float& e0, float& e1) {
  const float det = q00 * q11 - q01 * q01;
  const bool ok = fabsf(det) > (float)(1e-6);
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float n0 = (q11 * b0 - q01 * b1) * inv;
  const float n1 = (q00 * b1 - q01 * b0) * inv;
  e0 = ok ? n0 : e0;
  e1 = ok ? n1 : e1;
}

// Least-squares ramp fit: assign every pixel to its nearest interpolated
// level (and, for the 6-point family, to the literal 0/255 slots, which drop
// out of the fit), then solve the 2x2 normal equations. SLOTS levels of lv.
template <bool LITERAL, int SLOTS>
__device__ __forceinline__ void bc4_fit_ramp(const float (&vals)[16], const float (&lv)[8],
                                             int iters, float& e0, float& e1) {
  e0 = vals[0];
  e1 = vals[0];
#pragma unroll
  for (int p = 1; p < 16; ++p) {
    e0 = fminf(e0, vals[p]);
    e1 = fmaxf(e1, vals[p]);
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float q00 = 0.0f, q01 = 0.0f, q11 = 0.0f, b0 = 0.0f, b1 = 0.0f;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const float v = vals[p];
      float best = 0.0f, alpha = 0.0f, m = 1.0f;
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        const float l = lv[k];
        const float pp = e0 + l * (e1 - e0);
        const float d = (v - pp) * (v - pp);
        if (k == 0 || d < best) { best = d; alpha = l; }
      }
      if (LITERAL) {
        float d = v * v;                              // (v - 0)^2
        if (d < best) { best = d; m = 0.0f; }
        d = (v - 255.0f) * (v - 255.0f);
        if (d < best) { best = d; m = 0.0f; }
      }
      const float oa = 1.0f - alpha;
      const float t00 = m * (oa * oa);
      const float t01 = (m * alpha) * oa;
      const float t11 = (m * alpha) * alpha;
      const float tb0 = (m * oa) * v;
      const float tb1 = (m * alpha) * v;
      q00 = (p == 0) ? t00 : q00 + t00;
      q01 = (p == 0) ? t01 : q01 + t01;
      q11 = (p == 0) ? t11 : q11 + t11;
      b0 = (p == 0) ? tb0 : b0 + tb0;
      b1 = (p == 0) ? tb1 : b1 + tb1;
    }
    bc4_solve(q00, q01, q11, b0, b1, e0, e1);
  }
}

// Joint (a0, a1) hill climb on the exact ramp; rounds after the first use
// radius 1. A candidate with the wrong endpoint order for its family never
// wins, so it is skipped.
template <bool EIGHT>
__device__ __forceinline__ void bc4_sweep(const float (&vals)[16], int a0, int a1, int radius,
                                          int rounds, int& best_a0, int& best_a1,
                                          float& best) {
  best_a0 = a0;
  best_a1 = a1;
  best = bc4_assign_err<EIGHT>(vals, a0, a1);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const int rad = (r == 0) ? radius : 1;
    const int c_a0 = best_a0, c_a1 = best_a1;
#pragma unroll 1
    for (int d0 = -rad; d0 <= rad; ++d0) {
#pragma unroll 1
      for (int d1 = -rad; d1 <= rad; ++d1) {
        if (d0 == 0 && d1 == 0) continue;
        const int c0 = clamp_i(c_a0 + d0, 0, 255);
        const int c1 = clamp_i(c_a1 + d1, 0, 255);
        const bool ok = EIGHT ? (c0 > c1) : (c0 <= c1);
        if (!ok) continue;
        const float e2 = bc4_assign_err<EIGHT>(vals, c0, c1);
        if (e2 < best) { best_a0 = c0; best_a1 = c1; best = e2; }
      }
    }
  }
}

__device__ __forceinline__ void cswap(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// Batcher odd-even mergesort of 16 values (the compare-exchange pairs of
// kernels/bc4.py:_oem_pairs(16), in its order).
__device__ __forceinline__ void bc4_sort16(float (&r)[16]) {
  constexpr int PAIRS[63][2] = {
      {0, 1},   {2, 3},   {0, 2},   {1, 3},   {1, 2},   {4, 5},   {6, 7},   {4, 6},
      {5, 7},   {5, 6},   {0, 4},   {2, 6},   {2, 4},   {1, 5},   {3, 7},   {3, 5},
      {1, 2},   {3, 4},   {5, 6},   {8, 9},   {10, 11}, {8, 10},  {9, 11},  {9, 10},
      {12, 13}, {14, 15}, {12, 14}, {13, 15}, {13, 14}, {8, 12},  {10, 14}, {10, 12},
      {9, 13},  {11, 15}, {11, 13}, {9, 10},  {11, 12}, {13, 14}, {0, 8},   {4, 12},
      {4, 8},   {2, 10},  {6, 14},  {6, 10},  {2, 4},   {6, 8},   {10, 12}, {1, 9},
      {5, 13},  {5, 9},   {3, 11},  {7, 15},  {7, 11},  {3, 5},   {7, 9},   {11, 13},
      {1, 2},   {3, 4},   {5, 6},   {7, 8},   {9, 10},  {11, 12}, {13, 14}};
#pragma unroll
  for (int i = 0; i < 63; ++i) cswap(r[PAIRS[i][0]], r[PAIRS[i][1]]);
}

// The 8-point family (a0 > a1) whole on one thread: the fitted seed races
// the min/max seed, then the hill climb. vals in 0..255.
__device__ __forceinline__ void bc4_family8(const float (&vals)[16], int iters, int radius,
                                            int rounds, int& a0, int& a1, float& err) {
  const float W8[8] = {0.0f, 1.0f, (float)(1.0 / 7.0), (float)(2.0 / 7.0),
                       (float)(3.0 / 7.0), (float)(4.0 / 7.0), (float)(5.0 / 7.0),
                       (float)(6.0 / 7.0)};
  float fmin_ = vals[0], fmax_ = vals[0];
#pragma unroll
  for (int p = 1; p < 16; ++p) {
    fmin_ = fminf(fmin_, vals[p]);
    fmax_ = fmaxf(fmax_, vals[p]);
  }
  const int vmin = round_u8(fmin_);
  const int vmax = round_u8(fmax_);
  float e0, e1;
  bc4_fit_ramp<false, 8>(vals, W8, iters, e0, e1);
  const int hi = round_u8(fmaxf(e0, e1));
  const int lo = round_u8(fminf(e0, e1));
  const int hi8 = (hi > lo) ? hi : min(hi + 1, 255);
  const int vmax8 = (vmax > vmin) ? vmax : min(vmax + 1, 255);
  const float e_fit = bc4_assign_err<true>(vals, hi8, lo);
  const float e_mm = bc4_assign_err<true>(vals, vmax8, vmin);
  const bool mm = e_mm < e_fit;
  bc4_sweep<true>(vals, mm ? vmax8 : hi8, mm ? vmin : lo, radius, rounds, a0, a1, err);
}

// The 6-point family (a0 <= a1) whole on one thread: the fitted seed races 9
// trimmed-interval seeds (the sorted values' 3 lowest against their 3
// highest), then the hill climb. vals in 0..255.
__device__ __forceinline__ void bc4_family6(const float (&vals)[16], int iters, int radius,
                                            int rounds, int& a0, int& a1, float& err) {
  const float W6[8] = {0.0f, 1.0f, (float)(1.0 / 5.0), (float)(2.0 / 5.0),
                       (float)(3.0 / 5.0), (float)(4.0 / 5.0), 0.0f, 0.0f};
  float e0, e1;
  bc4_fit_ramp<true, 6>(vals, W6, iters, e0, e1);
  int seed0 = round_u8(fminf(e0, e1));
  int seed1 = round_u8(fmaxf(e0, e1));
  float seed_e = bc4_assign_err<false>(vals, seed0, seed1);
  float sv[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) sv[p] = vals[p];
  bc4_sort16(sv);
  int slo[3], shi[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    slo[i] = round_u8(sv[i]);
    shi[i] = round_u8(sv[15 - i]);
  }
#pragma unroll 1
  for (int ij = 0; ij < 9; ++ij) {
    const int i = ij / 3, j = ij - 3 * i;
    const int s0 = (i == 0) ? slo[0] : (i == 1 ? slo[1] : slo[2]);
    int s1 = (j == 0) ? shi[0] : (j == 1 ? shi[1] : shi[2]);
    s1 = max(s1, s0);
    const float e = bc4_assign_err<false>(vals, s0, s1);
    if (e < seed_e) { seed0 = s0; seed1 = s1; seed_e = e; }
  }
  bc4_sweep<false>(vals, seed0, seed1, radius, rounds, a0, a1, err);
}

// The pick between the families (the 8-point one keeps a tie) and the
// winner's endpoints and error.
__device__ __forceinline__ bool bc4_pick(int a0_8, int a1_8, float err8, int a0_6, int a1_6,
                                         float err6, int& a0, int& a1, float& err) {
  const bool use8 = err8 <= err6;
  a0 = use8 ? a0_8 : a0_6;
  a1 = use8 ? a1_8 : a1_6;
  err = use8 ? err8 : err6;
  return use8;
}

// DXT5 index layout (amd_bcx_helpers.cpp:32-46): bit 31 of word 0 carries the
// low bit of index 5.
__device__ __forceinline__ void pack_dxt5(int a0, int a1, const int (&idx)[16], uint32_t& w0,
                                          uint32_t& w1) {
  w0 = (uint32_t)a0 | ((uint32_t)a1 << 8);
#pragma unroll
  for (int p = 0; p < 5; ++p) w0 |= (uint32_t)idx[p] << (16 + 3 * p);
  const uint32_t i5 = (uint32_t)idx[5];
  w0 |= (i5 & 1u) << 31;
  w1 = (i5 & 6u) >> 1;
#pragma unroll
  for (int p = 6; p < 16; ++p) w1 |= (uint32_t)idx[p] << (2 + 3 * (p - 6));
}

}  // namespace bcx
