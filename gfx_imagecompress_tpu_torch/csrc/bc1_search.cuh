// BC1 colour search for one 4x4 block: the per-candidate arithmetic, the
// one-thread search of K1c and the lane-group search of K1a and of the colour
// half of K1b.
//
// Replaces the Pallas body gfx_imagecompress_tpu/kernels/bc1_pallas.py:
// _bc1_search (and _pca, _sweep1d, _iterate_lsq, _quant565, _refine,
// _refine3d, _fit_mode under it); it is the colour half of BC2 and BC3 too.
// The plain PyTorch version is kernels/bc1.py:_bc1_search; this file does the
// same float32 operations in the same order (build with -fmad=false, no fast
// math), enumerates candidates in the same order (first wins on equality) and
// sums the 16 pixels left to right, so both agree bit for bit.
//
// Bound: operations. A block is 256 bytes in and 12 bytes out against some
// fifty thousand f32/i32 operations: per colour mode (4 and 3 colours) a PCA
// axis, 24 ramp positions along it, two least-squares starts, and a
// sequential +/-1 jitter of the 565 endpoints (8 moves per channel, each a
// 16-pixel assign), or the 729-candidate joint cube (b3d).
//
// The arithmetic of one candidate lives in small helpers (chan_palette,
// eval_px / bc1_eval, ramp_err, bc1_lsq, table_px / move_px, tb_take) that
// both searches call, so there is one copy of it; the cube's (cube_gb_px,
// cube_red_px, cube_px) only K1a runs.
//
// bc1_search: one thread encodes a block, the 4-colour mode alone, opaque,
// with the refine, the 48 colour floats in its registers (K1c,
// csrc/bc23_group.cuh). On K1a's lane groups K1c read slower than this on
// the H100 (PERF.md), so it kept this search.
//
// bc1_group_*: K1a (csrc/bc1_kernel.cu) and the colour half of K1b
// (csrc/bc23_group.cuh: the 4-colour mode alone, opaque, the refine). A group
// of BC1_LANES lanes runs one mode of one block, the two modes of a block in
// two different warps (their code differs, so splitting them lane by lane
// would run both paths on every lane); with allow_three off only the
// 4-colour mode runs. The block sits in shared memory, read by both modes.
// The search is a sequence of phases; a
// phase is a function of the lane (and its private registers, Bc1Lane) handed
// to `run`, which on the card runs it on every lane and then the warp's
// __syncwarp (every group of a warp runs the same phases), and in the tests'
// host build runs it as a loop over the group's lanes. Control flow between
// phases depends only on launch arguments and on shared values written
// before a barrier. The phases deal work to the lanes in two ways:
//   - independent candidates, each whole in one lane, its result in a slot,
//     the winner picked afterwards by one lane scanning the slots in the
//     sequential order with the sequential loop's compare: the 16 coarse and
//     8 fine sweep positions, the two least-squares starts (one per lane),
//     the b3d cube's (green, blue) pairs (each with its red candidates; the
//     cube runs on a whole warp, BC1_CUBE_LANES lanes per (block, mode),
//     bc1_cube);
//   - pixels, where the work is one chain that cannot be split (the refine's
//     moves, each of which starts from the previous one's outcome, and the
//     assigns before and after it): each lane computes the terms of its
//     BC1_HP pixels (the refine's other-channel distances for those pixels
//     stay in its registers across the channel's 8 moves), writes them to
//     shared slots, and after the barrier one lane adds the weighted and
//     another the unweighted terms in pixel order.
// No sum is reordered and every winner is the sequential loop's, so the words
// and errors are the plain version's. The lanes stay at most 128 registers,
// without spills (ptxas -v, PERF.md).
#pragma once
#include "bcx_common.cuh"

namespace bcx {

#define BC1_EPS ((float)(1e-8))
#define BC1_TB_LO ((float)(1.0 - 0.05))
#define BC1_TB_HI ((float)(1.0 + 0.05))
#define BC1_UNIT3 ((float)(0.57735026))
#define BC1_BIG ((float)(1e30))

struct Bc1Budget {
  float w[3];        // base channel weights
  int iters;         // least-squares refit rounds
  int passes;        // jitter passes (cube: steps, capped at 1)
  int allow_three;   // race the 3-colour mode
  int use_alpha;     // punch-through
  float athr255;     // alpha threshold in 0..255 units
  int adaptive;      // per-block adaptive weights
  int b3d;           // joint 3-channel cube instead of the jitter
};

// One 565 component -> decoded 8-bit (bit replication).
__device__ __forceinline__ int expand_ch(int q, int ch) {
  return (ch == 1) ? ((q << 2) | (q >> 4)) : ((q << 3) | (q >> 2));
}

// Decoded palette of one channel (decode/bcn.py rounding); K = FOUR ? 4 : 3.
template <bool FOUR>
__device__ __forceinline__ void chan_palette(int a, int b, int ch, float (&e)[4]) {
  const int e0 = expand_ch(a, ch), e1 = expand_ch(b, ch);
  e[0] = (float)e0;
  e[1] = (float)e1;
  if (FOUR) {
    e[2] = (float)((2 * e0 + e1 + 1) / 3);
    e[3] = (float)((e0 + 2 * e1 + 1) / 3);
  } else {
    e[2] = (float)((e0 + e1 + 1) >> 1);
    e[3] = 0.0f;
  }
}

template <bool FOUR>
__device__ __forceinline__ void palette3(const int (&q0)[3], const int (&q1)[3],
                                         float (&pal)[3][4]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) chan_palette<FOUR>(q0[c], q1[c], c, pal[c]);
}

__device__ __forceinline__ bool tb_take(float werr, float uerr, float best_w, float best_u) {
  const bool win = werr < best_w * BC1_TB_LO;
  const bool tie = (werr <= best_w * BC1_TB_HI) && (uerr < best_u);
  return win || tie;
}

// Ramp levels and the midpoints between them.
template <bool FOUR>
__device__ __forceinline__ void bc1_levels(float (&lv)[4], float (&mids)[3]) {
  lv[0] = 0.0f;
  lv[1] = FOUR ? (float)(1.0 / 3.0) : 0.5f;
  lv[2] = FOUR ? (float)(2.0 / 3.0) : 1.0f;
  lv[3] = 1.0f;
  mids[0] = FOUR ? (float)((0.0 + 1.0 / 3.0) * 0.5) : (float)((0.0 + 0.5) * 0.5);
  mids[1] = FOUR ? (float)((1.0 / 3.0 + 2.0 / 3.0) * 0.5) : (float)((0.5 + 1.0) * 0.5);
  mids[2] = (float)((2.0 / 3.0 + 1.0) * 0.5);
}

// Pixel p's nearest palette entry under the weighted distance (first wins on
// equality), its weighted and unweighted distance; a masked pixel costs 0.
// The unweighted distance is formed for the nearest entry only, from its
// channel differences (the same expression as for every entry).
template <bool FOUR, bool MASKED>
__device__ __forceinline__ void eval_px(const float (&xs)[3][16], const float (&m)[16],
                                        const float (&w)[3], const float (&pal)[3][4], int p,
                                        uint32_t& bi, float& best_d, float& best_u) {
  constexpr int K = FOUR ? 4 : 3;
  float bdiff[3] = {0.0f, 0.0f, 0.0f};
  best_d = 0.0f;
  bi = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float d = 0.0f, diff[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      diff[c] = xs[c][p] - pal[c][k];
      d = d + (w[c] * diff[c]) * diff[c];
    }
    if (k == 0 || d < best_d) {
      best_d = d;
      bi = (uint32_t)k;
#pragma unroll
      for (int c = 0; c < 3; ++c) bdiff[c] = diff[c];
    }
  }
  best_u = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) best_u = best_u + bdiff[c] * bdiff[c];
  if (MASKED) { best_d = best_d * m[p]; best_u = best_u * m[p]; }
}

// Every pixel's nearest entry: 2-bit indices packed LSB first, the weighted
// error and the unweighted error of that assignment.
template <bool FOUR, bool MASKED>
__device__ __forceinline__ void bc1_eval(const float (&xs)[3][16], const float (&m)[16],
                                         const float (&w)[3], const int (&q0)[3],
                                         const int (&q1)[3], uint32_t& idx, float& err,
                                         float& uerr) {
  float pal[3][4];
  palette3<FOUR>(q0, q1, pal);
  idx = 0u;
  err = 0.0f;
  uerr = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    uint32_t bi;
    float best_d, best_u;
    eval_px<FOUR, MASKED>(xs, m, w, pal, p, bi, best_d, best_u);
    idx |= bi << (2 * p);
    err = (p == 0) ? best_d : err + best_d;
    uerr = (p == 0) ? best_u : uerr + best_u;
  }
}

// Sum over the pixels of the squared distance of the projection t to the
// nearest level of the ramp lo..hi.
template <bool FOUR, bool MASKED>
__device__ __forceinline__ float ramp_err(const float (&t)[16], const float (&m)[16],
                                          const float (&lv)[4], float lo, float hi) {
  constexpr int K = FOUR ? 4 : 3;
  float sum = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    float d = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float r = t[p] - (lo + lv[k] * (hi - lo));
      const float dk = r * r;
      d = (k == 0) ? dk : fminf(d, dk);
    }
    if (MASKED) d = d * m[p];
    sum = (p == 0) ? d : sum + d;
  }
  return sum;
}

// Per-block adaptive weights (mean-channel skew applied to the base
// weights), or the base weights.
__device__ __forceinline__ void bc1_weights(const float (&xs)[3][16], const Bc1Budget& bud,
                                            float (&w)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) w[c] = bud.w[c];
  if (!bud.adaptive) return;
  float mc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = xs[c][0];
#pragma unroll
    for (int p = 1; p < 16; ++p) s = s + xs[c][p];
    mc[c] = s / 16.0f;
  }
  const float largest = fmaxf(fmaxf(mc[0], mc[1]), fmaxf(mc[2], (float)(1e-6)));
#pragma unroll
  for (int c = 0; c < 3; ++c) w[c] = (bud.w[c] * (3.0f * mc[c] / largest + 1.0f)) * 0.25f;
  const float s = w[0] + w[1] + w[2];
#pragma unroll
  for (int c = 0; c < 3; ++c) w[c] = w[c] / s;
}

// PCA axis (power iteration seeded with ones), the projections on it and
// their (masked) extents.
template <bool MASKED>
__device__ __forceinline__ void bc1_axis(const float (&xs)[3][16], const float (&m)[16],
                                         float (&mean)[3], float (&axis)[3], float (&t)[16],
                                         float& tmin_out, float& tmax_out) {
  float cnt = 16.0f;
  if (MASKED) {
    float s = m[0];
#pragma unroll
    for (int p = 1; p < 16; ++p) s = s + m[p];
    cnt = fmaxf(s, 1.0f);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const float v = MASKED ? xs[c][p] * m[p] : xs[c][p];
      s = (p == 0) ? v : s + v;
    }
    mean[c] = s / cnt;
  }
  float cov[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // 00 01 02 11 12 22
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    float cen[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      cen[c] = xs[c][p] - mean[c];
      if (MASKED) cen[c] = cen[c] * m[p];
    }
    const float t00 = cen[0] * cen[0], t01 = cen[0] * cen[1], t02 = cen[0] * cen[2];
    const float t11 = cen[1] * cen[1], t12 = cen[1] * cen[2], t22 = cen[2] * cen[2];
    cov[0] = (p == 0) ? t00 : cov[0] + t00;
    cov[1] = (p == 0) ? t01 : cov[1] + t01;
    cov[2] = (p == 0) ? t02 : cov[2] + t02;
    cov[3] = (p == 0) ? t11 : cov[3] + t11;
    cov[4] = (p == 0) ? t12 : cov[4] + t12;
    cov[5] = (p == 0) ? t22 : cov[5] + t22;
  }
  float v0 = 1.0f, v1 = 1.0f, v2 = 1.0f;
#pragma unroll 1
  for (int it = 0; it < 8; ++it) {
    const float n0 = cov[0] * v0 + cov[1] * v1 + cov[2] * v2;
    const float n1 = cov[1] * v0 + cov[3] * v1 + cov[4] * v2;
    const float n2 = cov[2] * v0 + cov[4] * v1 + cov[5] * v2;
    const float n = sqrtf(n0 * n0 + n1 * n1 + n2 * n2);
    const bool ok = n > BC1_EPS;
    const float inv = 1.0f / fmaxf(n, BC1_EPS);
    v0 = ok ? n0 * inv : v0;
    v1 = ok ? n1 * inv : v1;
    v2 = ok ? n2 * inv : v2;
  }
  {
    const float n = sqrtf(v0 * v0 + v1 * v1 + v2 * v2);
    const bool ok = n > BC1_EPS;
    const float inv = 1.0f / fmaxf(n, BC1_EPS);
    axis[0] = ok ? v0 * inv : BC1_UNIT3;
    axis[1] = ok ? v1 * inv : BC1_UNIT3;
    axis[2] = ok ? v2 * inv : BC1_UNIT3;
  }
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float cen = xs[c][p] - mean[c];
      if (MASKED) cen = cen * m[p];
      acc = acc + cen * axis[c];
    }
    t[p] = acc;
    const float tlo = MASKED ? (m[p] > 0.0f ? acc : BC1_BIG) : acc;
    const float thi = MASKED ? (m[p] > 0.0f ? acc : -BC1_BIG) : acc;
    tmin = (p == 0) ? tlo : fminf(tmin, tlo);
    tmax = (p == 0) ? thi : fmaxf(tmax, thi);
  }
  if (MASKED) {
    tmin = (tmin > tmax) ? 0.0f : tmin;
    tmax = (tmax < tmin) ? 0.0f : tmax;
  }
  tmin_out = tmin;
  tmax_out = tmax;
}

// ---- the endpoint-position sweep along the axis: 4x4 coarse, 3x3 fine
__device__ __forceinline__ void sweep_frame(float tmin, float tmax, float& scl0, float& s) {
  const float span = tmax - tmin;
  scl0 = tmin - span * 0.125f;
  s = span * 1.25f;
}

// coarse position i (0..15: low anchor i / 4, high anchor i % 4)
__device__ __forceinline__ void coarse_pos(int i, float scl0, float s, float& lo, float& hi) {
  const float cl[4] = {(float)(0.05 + 0 * 0.025), (float)(0.05 + 2 * 0.025),
                       (float)(0.05 + 4 * 0.025), (float)(0.05 + 6 * 0.025)};
  const float chh[4] = {(float)(0.95 - 0 * 0.025), (float)(0.95 - 2 * 0.025),
                        (float)(0.95 - 4 * 0.025), (float)(0.95 - 6 * 0.025)};
  const int l = i >> 2, h = i & 3;
  const float fl = (l == 0) ? cl[0] : (l == 1) ? cl[1] : (l == 2) ? cl[2] : cl[3];
  const float fh = (h == 0) ? chh[0] : (h == 1) ? chh[1] : (h == 2) ? chh[2] : chh[3];
  lo = scl0 + fl * s;
  hi = scl0 + fh * s;
}

__device__ __forceinline__ float fine_step(float s) { return (float)(0.025) * s; }

// fine position i (0..8 but 4: one step of each anchor around lo0, hi0)
__device__ __forceinline__ void fine_pos(int i, float lo0, float hi0, float stp, float& lo,
                                         float& hi) {
  const float dl = (float)(i / 3 - 1), dh = (float)(i % 3 - 1);
  lo = lo0 + dl * stp;
  hi = hi0 + dh * stp;
}

// One least-squares start: endpoints at lo, hi along the axis, `iters`
// rounds of (assign -> refit), 565 quantise, and the weighted and unweighted
// error of the quantised endpoints (the refine's start, if this start wins).
template <bool FOUR, bool MASKED>
__device__ __forceinline__ void bc1_lsq(const float (&xs)[3][16], const float (&m)[16],
                                        const float (&w)[3], int iters, const float (&mean)[3],
                                        const float (&axis)[3], float lo, float hi,
                                        int (&c0)[3], int (&c1)[3], float& e, float& u) {
  constexpr int K = FOUR ? 4 : 3;
  float lv[4], mids[3];
  bc1_levels<FOUR>(lv, mids);
  float e0[3], e1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e0[c] = mean[c] + lo * axis[c];
    e1[c] = mean[c] + hi * axis[c];
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float dirv[3];
    float l2 = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dirv[c] = (e1[c] - e0[c]) * w[c];
      l2 = l2 + dirv[c] * (e1[c] - e0[c]);
    }
    const float inv = (l2 > BC1_EPS) ? 1.0f / fmaxf(l2, BC1_EPS) : 0.0f;
    float q00 = 0.0f, q01 = 0.0f, q11 = 0.0f;
    float b0[3] = {0.0f, 0.0f, 0.0f}, b1[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      float tt = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) tt = tt + (xs[c][p] - e0[c]) * dirv[c];
      tt = tt * inv;
      int kidx = 0;
#pragma unroll
      for (int j = 0; j < K - 1; ++j) kidx += (tt > mids[j]) ? 1 : 0;
      float alpha = 0.0f;
#pragma unroll
      for (int k = 1; k < K; ++k) alpha = (kidx == k) ? lv[k] : alpha;
      float one_a = 1.0f - alpha;
      float a_m = alpha;
      if (MASKED) { one_a = one_a * m[p]; a_m = alpha * m[p]; }
      const float t00 = one_a * (1.0f - alpha);
      const float t01 = one_a * alpha;
      const float t11 = a_m * alpha;
      q00 = (p == 0) ? t00 : q00 + t00;
      q01 = (p == 0) ? t01 : q01 + t01;
      q11 = (p == 0) ? t11 : q11 + t11;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float u0 = one_a * xs[c][p], u1 = a_m * xs[c][p];
        b0[c] = (p == 0) ? u0 : b0[c] + u0;
        b1[c] = (p == 0) ? u1 : b1[c] + u1;
      }
    }
    const float det = q00 * q11 - q01 * q01;
    const bool okd = fabsf(det) > (float)(1e-6);
    const float invd = 1.0f / (okd ? det : 1.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float n0 = (q11 * b0[c] - q01 * b1[c]) * invd;
      const float n1 = (q00 * b1[c] - q01 * b0[c]) * invd;
      e0[c] = okd ? n0 : e0[c];
      e1[c] = okd ? n1 : e1[c];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float maxq = (c == 1) ? 63.0f : 31.0f;
    const float scale = (c == 1) ? (float)(63 / 255.0) : (float)(31 / 255.0);
    c0[c] = (int)fminf(fmaxf(rintf(e0[c] * scale), 0.0f), maxq);
    c1[c] = (int)fminf(fmaxf(rintf(e1[c] * scale), 0.0f), maxq);
  }
  uint32_t idx_unused;
  bc1_eval<FOUR, MASKED>(xs, m, w, c0, c1, idx_unused, e, u);
}

// ---- the refine: sequential per-channel +/-1 jitter of the 565 endpoints
// under the exact integer palette, with the unweighted tie-break

// pixel p's distance to each palette entry over the two channels that stay
template <bool FOUR>
__device__ __forceinline__ void table_px(const float (&xs)[3][16], const float (&w)[3],
                                         const float (&pal)[3][4], int ch, int p,
                                         float (&od)[4], float (&ou)[4]) {
  constexpr int K = FOUR ? 4 : 3;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float d = 0.0f, u = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c != ch) {
        const float diff = xs[c][p] - pal[c][k];
        d = d + (w[c] * diff) * diff;
        u = u + diff * diff;
      }
    }
    od[k] = d;
    ou[k] = u;
  }
}

// move mv (0..8, 4 is no move) of channel ch: its codes and their palette
template <bool FOUR>
__device__ __forceinline__ void move_cand(int q0c, int q1c, int ch, int mv, int& c0, int& c1,
                                          float (&ech)[4]) {
  const int maxq = (ch == 1) ? 63 : 31;
  const int d0 = mv / 3 - 1, d1 = mv % 3 - 1;
  c0 = clamp_i(q0c + d0, 0, maxq);
  c1 = clamp_i(q1c + d1, 0, maxq);
  chan_palette<FOUR>(c0, c1, ch, ech);
}

// pixel p (channel value x, mask mp) under a move: nearest entry's weighted
// and unweighted distance (the latter formed for the nearest entry only)
template <bool FOUR, bool MASKED>
__device__ __forceinline__ void move_px(float x, float mp, float wch, const float (&od)[4],
                                        const float (&ou)[4], const float (&ech)[4],
                                        float& dbest, float& ubest) {
  constexpr int K = FOUR ? 4 : 3;
  float bou = 0.0f, bdiff = 0.0f;
  dbest = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float diff = x - ech[k];
    const float dk = od[k] + (wch * diff) * diff;
    if (k == 0 || dk < dbest) { dbest = dk; bou = ou[k]; bdiff = diff; }
  }
  ubest = bou + bdiff * bdiff;
  if (MASKED) { dbest = dbest * mp; ubest = ubest * mp; }
}

// ---- the joint 3-channel endpoint cube (Refine3D): all (2*steps+1)^6
// simultaneous moves of the six 565 components, green outermost, then blue,
// then red; steps is capped at 1
__device__ __forceinline__ int cube_steps(int passes) {
  return passes < 1 ? (passes < 0 ? 0 : passes) : 1;
}

// candidate j of channel c around (q0c, q1c): its codes and palette
template <bool FOUR>
__device__ __forceinline__ void cube_cand(int q0c, int q1c, int c, int j, int steps,
                                          float (&e)[4], int& c0, int& c1) {
  const int side = 2 * steps + 1;
  const int maxq = (c == 1) ? 63 : 31;
  const int d0 = j / side - steps, d1 = j % side - steps;
  c0 = clamp_i(q0c + d0, 0, maxq);
  c1 = clamp_i(q1c + d1, 0, maxq);
  chan_palette<FOUR>(c0, c1, c, e);
}

// green and blue part of a pixel's (green x1, blue x2) distance to every
// entry
template <bool FOUR>
__device__ __forceinline__ void cube_gb_px(float x1, float x2, const float (&w)[3],
                                           const float (&eg)[4], const float (&eb)[4],
                                           float (&gb)[4]) {
  constexpr int K = FOUR ? 4 : 3;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float rg = x1 - eg[k], rb = x2 - eb[k];
    gb[k] = w[1] * (rg * rg) + w[2] * (rb * rb);
  }
}

// red part of a pixel's (red x0) distance to every entry of one red
// candidate
template <bool FOUR>
__device__ __forceinline__ void cube_red_px(float x0, float w0, const float (&er)[4],
                                            float (&rt)[4]) {
  constexpr int K = FOUR ? 4 : 3;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float rr = x0 - er[k];
    rt[k] = w0 * (rr * rr);
  }
#pragma unroll
  for (int k = K; k < 4; ++k) rt[k] = 0.0f;
}

// a pixel's (mask mp) distance to its nearest entry, from its green-blue
// and red parts
template <bool FOUR, bool MASKED>
__device__ __forceinline__ float cube_px(const float (&gb)[4], const float (&rt)[4], float mp) {
  constexpr int K = FOUR ? 4 : 3;
  float dbest = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float dk = gb[k] + rt[k];
    dbest = (k == 0) ? dk : fminf(dbest, dk);
  }
  if (MASKED) dbest = dbest * mp;
  return dbest;
}

// ---- the race of the two modes

// 4-colour codes and indices -> endpoint words in 4-colour order (c0 > c1)
__device__ __forceinline__ void bc1_order4(const int (&q0)[3], const int (&q1)[3], uint32_t idx,
                                           uint32_t& a0, uint32_t& a1, uint32_t& pidx) {
  const uint32_t c0 = ((uint32_t)q0[0] << 11) | ((uint32_t)q0[1] << 5) | (uint32_t)q0[2];
  const uint32_t c1 = ((uint32_t)q1[0] << 11) | ((uint32_t)q1[1] << 5) | (uint32_t)q1[2];
  const bool swap = c0 < c1;
  a0 = swap ? c1 : c0;
  a1 = swap ? c0 : c1;
  pidx = swap ? (idx ^ 0x55555555u) : idx;           // [1,0,3,2]
}

// 3-colour codes and indices -> words in 3-colour order (c0 <= c1),
// transparent pixels on index 3
template <bool MASKED>
__device__ __forceinline__ void bc1_order3(const int (&q0)[3], const int (&q1)[3], uint32_t idx,
                                           const float (&m)[16], uint32_t& a0, uint32_t& a1,
                                           uint32_t& pidx, bool& has_t) {
  const uint32_t c0 = ((uint32_t)q0[0] << 11) | ((uint32_t)q0[1] << 5) | (uint32_t)q0[2];
  const uint32_t c1 = ((uint32_t)q1[0] << 11) | ((uint32_t)q1[1] << 5) | (uint32_t)q1[2];
  const bool swap = c0 > c1;
  a0 = swap ? c1 : c0;
  a1 = swap ? c0 : c1;
  pidx = 0u;
  has_t = false;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    uint32_t i = (idx >> (2 * p)) & 3u;
    if (swap && i < 2u) i ^= 1u;                     // [1,0,2,3]
    if (MASKED && !(m[p] > 0.5f)) { i = 3u; has_t = true; }
    pidx |= i << (2 * p);
  }
}

// 4-colour wins on the tie-break unless its endpoints coincide or a pixel is
// transparent
__device__ __forceinline__ bool bc1_use4(float err4, float uerr4, float err3, float uerr3,
                                         uint32_t a0_4, uint32_t a1_4, bool has_t) {
  return tb_take(err4, uerr4, err3, uerr3) && !(a0_4 == a1_4) && !has_t;
}

// ---- the one-thread search (K1c): the 4-colour mode alone, opaque,
// with the refine. The opaque helpers read no mask: `m` is a placeholder.

// best, best_u: the weighted and unweighted error of the start q0/q1
__device__ __forceinline__ void bc1_refine4(const float (&xs)[3][16], const float (&w)[3],
                                            int passes, int (&q0)[3], int (&q1)[3], float best,
                                            float best_u) {
#pragma unroll 1
  for (int pass = 0; pass < passes; ++pass) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float od[16][4], ou[16][4];
      {
        float pal[3][4];
        palette3<true>(q0, q1, pal);
#pragma unroll
        for (int p = 0; p < 16; ++p) table_px<true>(xs, w, pal, ch, p, od[p], ou[p]);
      }
#pragma unroll 1
      for (int mv = 0; mv < 9; ++mv) {
        if (mv == 4) continue;                       // (0, 0)
        int c0, c1;
        float ech[4];
        move_cand<true>(q0[ch], q1[ch], ch, mv, c0, c1, ech);
        float err = 0.0f, uerr = 0.0f;
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          float dbest, ubest;
          move_px<true, false>(xs[ch][p], 1.0f, w[ch], od[p], ou[p], ech, dbest, ubest);
          err = (p == 0) ? dbest : err + dbest;
          uerr = (p == 0) ? ubest : uerr + ubest;
        }
        if (tb_take(err, uerr, best, best_u)) {
          best = err;
          best_u = uerr;
          q0[ch] = c0;
          q1[ch] = c1;
        }
      }
    }
  }
}

// PCA axis, endpoint-position sweep, two least-squares starts, 565
// quantise, refine, final assign. xs in 0..255. Returns the two 565 endpoint
// words in 4-colour order, the 2-bit indices and the weighted error.
__device__ __forceinline__ void bc1_search(const float (&xs)[3][16], const Bc1Budget& bud,
                                           uint32_t& a0, uint32_t& a1, uint32_t& pidx,
                                           float& err) {
  const float (&m)[16] = xs[0];
  float w[3];
  bc1_weights(xs, bud, w);
  float lv[4], mids[3];
  bc1_levels<true>(lv, mids);
  float mean[3], axis[3], t[16], tmin, tmax;
  bc1_axis<false>(xs, m, mean, axis, t, tmin, tmax);
  float scl0, s;
  sweep_frame(tmin, tmax, scl0, s);
  float be = 0.0f, blo = 0.0f, bhi = 0.0f;
#pragma unroll 1
  for (int i = 0; i < 16; ++i) {
    float lo, hi;
    coarse_pos(i, scl0, s, lo, hi);
    const float e = ramp_err<true, false>(t, m, lv, lo, hi);
    if (i == 0 || e < be) { be = e; blo = lo; bhi = hi; }
  }
  const float stp = fine_step(s);
  const float lo0 = blo, hi0 = bhi;
#pragma unroll 1
  for (int i = 0; i < 9; ++i) {
    if (i == 4) continue;
    float lo, hi;
    fine_pos(i, lo0, hi0, stp, lo, hi);
    const float e = ramp_err<true, false>(t, m, lv, lo, hi);
    if (e < be) { be = e; blo = lo; bhi = hi; }
  }

  // two least-squares starts (the projection bounds, the sweep's pick);
  // the second replaces the first only if strictly better
  int q0[3], q1[3];
  float best_e = 0.0f, best_u = 0.0f;
#pragma unroll 1
  for (int cand = 0; cand < 2; ++cand) {
    int c0[3], c1[3];
    float e, u;
    bc1_lsq<true, false>(xs, m, w, bud.iters, mean, axis, cand ? blo : tmin, cand ? bhi : tmax,
                         c0, c1, e, u);
    if (cand == 0 || e < best_e) {
      best_e = e;
      best_u = u;
#pragma unroll
      for (int c = 0; c < 3; ++c) { q0[c] = c0[c]; q1[c] = c1[c]; }
    }
  }

  bc1_refine4(xs, w, bud.passes, q0, q1, best_e, best_u);
  uint32_t idx;
  float uerr;
  bc1_eval<true, false>(xs, m, w, q0, q1, idx, err, uerr);
  bc1_order4(q0, q1, idx, a0, a1, pidx);
}

// ---- the lane-group search (K1a, the colour half of K1b)

constexpr int BC1_LANES = 2;                  // lanes per (block, mode)
constexpr int BC1_HP = 16 / BC1_LANES;        // pixels per lane in the pixel phases
constexpr int BC1_CTA_BLOCKS = 32;            // blocks per CTA of K1a

// A block, read by its two modes: its pixels, weights and PCA axis (the
// axis does not depend on the mode).
struct Bc1Block {
  float xs[3][16];    // 0..255
  float m[16];        // opaque mask (1 everywhere without punch-through)
  float w[3];         // channel weights
  float mean[3], axis[3];
  float t[16];        // projections on the axis
  float tmin, tmax;   // and their (masked) extents
};

// One mode's state.
struct Bc1Fit {
  struct { float e[16], lo[16], hi[16]; } sw;   // the sweep's slots
  float be, blo, bhi;                 // the sweep's incumbent
  float ce[BC1_LANES], cu[BC1_LANES];  // least-squares starts: errors, codes
  int cq[BC1_LANES][6];
  int q0[3], q1[3];                   // the mode's endpoint codes
  float best, best_u;                 // the refine's incumbent
  float sd, su;                       // an assign's chains over lane 0's pixels
  uint32_t idx0;                      // and its indices
  uint32_t idx;                       // the result: indices, weighted and
  float err, uerr;                    // unweighted error
};

// The cube of one (block, mode) runs on a whole warp, BC1_CUBE_LANES lanes
// (a warp's blocks one after the other), with this scratch: the red
// candidates' terms of every pixel, and each lane's best candidate and its
// index.
constexpr int BC1_CUBE_LANES = 32;
constexpr int BC1_CUBE_SIDE = 9;              // moves of one channel (steps = 1)
struct Bc1Cube {
  float4 rt[16][BC1_CUBE_SIDE];               // [pixel][red candidate][entry]
  float e[BC1_CUBE_LANES];
  int i[BC1_CUBE_LANES];
};

// A lane's registers that outlive a phase: the refine's distances of its
// pixels over the two channels that stay (for the channel's 8 moves), and
// the per-pixel terms of its pixels' half of an assign.
struct Bc1Lane {
  float od[BC1_HP][4], ou[BC1_HP][4];
  float td[BC1_HP], tu[BC1_HP];
  uint32_t idx;
};

// Loads block `px` (C floats per pixel, in [0,1]) scaled to 0..255 and its
// mask, and, where a255 is given (BC3: C is 4), its alpha scaled to 0..255
// into a255; then the axis (lane 0) and the weights (lane 1).
template <bool MASKED, class Run>
__device__ __forceinline__ void bc1_group_load(Bc1Block& b, const float* __restrict__ px, int C,
                                               const Bc1Budget& bud, Run&& run,
                                               float* a255 = nullptr) {
  run([&](int lane, Bc1Lane&) {
#pragma unroll 1
    for (int p = lane; p < 16; p += BC1_LANES) {
      float f[4];
      if (C == 4) {
        const float4 v = reinterpret_cast<const float4*>(px)[p];
        f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < (MASKED ? 4 : 3); ++c) f[c] = px[p * C + c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) b.xs[c][p] = f[c] * 255.0f;
      b.m[p] = MASKED ? ((f[3] * 255.0f >= bud.athr255) ? 1.0f : 0.0f) : 1.0f;
      if (a255 != nullptr) a255[p] = f[3] * 255.0f;
    }
  });
  run([&](int lane, Bc1Lane&) {
    if (lane == 0) {
      float mean[3], axis[3], t[16], tmin, tmax;
      bc1_axis<MASKED>(b.xs, b.m, mean, axis, t, tmin, tmax);
#pragma unroll
      for (int c = 0; c < 3; ++c) { b.mean[c] = mean[c]; b.axis[c] = axis[c]; }
#pragma unroll
      for (int p = 0; p < 16; ++p) b.t[p] = t[p];
      b.tmin = tmin;
      b.tmax = tmax;
    } else {
      float w[3];
      bc1_weights(b.xs, bud, w);
#pragma unroll
      for (int c = 0; c < 3; ++c) b.w[c] = w[c];
    }
  });
}

// An assign (palette of f.q0/f.q1) split by pixel, first phase: each lane
// the terms of its 8 pixels into r.td/r.tu and their index bits into r.idx;
// lane 0 then the chains over its pixels into f.sd/f.su and its bits into
// f.idx0. Lane 1 finishes the chains in the next phase (chain_on).
template <bool FOUR, bool MASKED>
__device__ __forceinline__ void group_assign_half(const Bc1Block& b, Bc1Fit& f, int lane,
                                                  Bc1Lane& r) {
  float pal[3][4];
  palette3<FOUR>(f.q0, f.q1, pal);
  uint32_t idx = 0u;
#pragma unroll
  for (int j = 0; j < BC1_HP; ++j) {
    const int p = lane * BC1_HP + j;
    uint32_t bi;
    eval_px<FOUR, MASKED>(b.xs, b.m, b.w, pal, p, bi, r.td[j], r.tu[j]);
    idx |= bi << (2 * p);
  }
  r.idx = idx;
  if (lane == 0) {
    float sd = r.td[0], su = r.tu[0];
#pragma unroll
    for (int j = 1; j < BC1_HP; ++j) { sd = sd + r.td[j]; su = su + r.tu[j]; }
    f.sd = sd;
    f.su = su;
    f.idx0 = idx;
  }
}

// the rest of a chain: s + t[0] + t[1] + ..., left to right
__device__ __forceinline__ float chain_on(float s, const float (&t)[BC1_HP]) {
#pragma unroll
  for (int j = 0; j < BC1_HP; ++j) s = s + t[j];
  return s;
}

// One mode of block b into f, first part: sweep, least squares; the pick
// is the refine's (or the cube's) start.
template <bool FOUR, bool MASKED, class Run>
__device__ __forceinline__ void bc1_group_start(const Bc1Block& b, Bc1Fit& f,
                                                const Bc1Budget& bud, Run&& run) {
  constexpr int L = BC1_LANES;
  static_assert(L == 2, "one least-squares start per lane");
  // a. the 16 coarse positions, then the in-order pick (first wins)
  run([&](int lane, Bc1Lane&) {
    float lv[4], mids[3], scl0, s;
    bc1_levels<FOUR>(lv, mids);
    sweep_frame(b.tmin, b.tmax, scl0, s);
#pragma unroll 1
    for (int i = lane; i < 16; i += L) {
      float lo, hi;
      coarse_pos(i, scl0, s, lo, hi);
      f.sw.e[i] = ramp_err<FOUR, MASKED>(b.t, b.m, lv, lo, hi);
      f.sw.lo[i] = lo;
      f.sw.hi[i] = hi;
    }
  });
  run([&](int lane, Bc1Lane&) {
    if (lane) return;
    float be = f.sw.e[0], blo = f.sw.lo[0], bhi = f.sw.hi[0];
#pragma unroll 1
    for (int i = 1; i < 16; ++i)
      if (f.sw.e[i] < be) { be = f.sw.e[i]; blo = f.sw.lo[i]; bhi = f.sw.hi[i]; }
    f.be = be;
    f.blo = blo;
    f.bhi = bhi;
  });
  // b. the 8 fine positions around the pick, then the pick among them
  run([&](int lane, Bc1Lane&) {
    float lv[4], mids[3], scl0, s;
    bc1_levels<FOUR>(lv, mids);
    sweep_frame(b.tmin, b.tmax, scl0, s);
    const float stp = fine_step(s);
#pragma unroll 1
    for (int j = lane; j < 8; j += L) {
      float lo, hi;
      fine_pos(j < 4 ? j : j + 1, f.blo, f.bhi, stp, lo, hi);
      f.sw.e[j] = ramp_err<FOUR, MASKED>(b.t, b.m, lv, lo, hi);
      f.sw.lo[j] = lo;
      f.sw.hi[j] = hi;
    }
  });
  run([&](int lane, Bc1Lane&) {
    if (lane) return;
    float be = f.be;
#pragma unroll 1
    for (int j = 0; j < 8; ++j)
      if (f.sw.e[j] < be) { be = f.sw.e[j]; f.blo = f.sw.lo[j]; f.bhi = f.sw.hi[j]; }
  });
  // c. the two least-squares starts, one per lane; the second replaces the
  // first only if strictly better
  run([&](int lane, Bc1Lane&) {
    int c0[3], c1[3];
    float e, u;
    bc1_lsq<FOUR, MASKED>(b.xs, b.m, b.w, bud.iters, b.mean, b.axis, lane ? f.blo : b.tmin,
                          lane ? f.bhi : b.tmax, c0, c1, e, u);
    f.ce[lane] = e;
    f.cu[lane] = u;
#pragma unroll
    for (int c = 0; c < 3; ++c) { f.cq[lane][c] = c0[c]; f.cq[lane][3 + c] = c1[c]; }
  });
  // the pick is also the refine's start and its error
  run([&](int lane, Bc1Lane&) {
    if (lane) return;
    const int s = f.ce[1] < f.ce[0] ? 1 : 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) { f.q0[c] = f.cq[s][c]; f.q1[c] = f.cq[s][3 + c]; }
    f.best = f.ce[s];
    f.best_u = f.cu[s];
  });
}

// d. the refine. Every assign is split by pixel: lane 0 adds its pixels'
// terms, lane 1 adds its own onto that in the next phase and decides.
template <bool FOUR, bool MASKED, class Run>
__device__ __forceinline__ void bc1_group_refine(const Bc1Block& b, Bc1Fit& f,
                                                 const Bc1Budget& bud, Run&& run) {
  static_assert(BC1_LANES == 2, "lane 0 starts each chain, lane 1 finishes it");
#pragma unroll 1
  for (int pass = 0; pass < bud.passes; ++pass) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      // the lane's pixels' distances over the two channels that stay
      run([&](int lane, Bc1Lane& r) {
        float pal[3][4];
        palette3<FOUR>(f.q0, f.q1, pal);
#pragma unroll
        for (int j = 0; j < BC1_HP; ++j)
          table_px<FOUR>(b.xs, b.w, pal, ch, lane * BC1_HP + j, r.od[j], r.ou[j]);
      });
#pragma unroll 1
      for (int mv = 0; mv < 9; ++mv) {
        if (mv == 4) continue;                     // (0, 0)
        // the move's terms by pixel; lane 0 starts the two chains
        run([&](int lane, Bc1Lane& r) {
          int c0, c1;
          float ech[4];
          move_cand<FOUR>(f.q0[ch], f.q1[ch], ch, mv, c0, c1, ech);
#pragma unroll
          for (int j = 0; j < BC1_HP; ++j) {
            const int p = lane * BC1_HP + j;
            move_px<FOUR, MASKED>(b.xs[ch][p], b.m[p], b.w[ch], r.od[j], r.ou[j], ech,
                                  r.td[j], r.tu[j]);
          }
          if (lane == 0) {
            float sd = r.td[0], su = r.tu[0];
#pragma unroll
            for (int j = 1; j < BC1_HP; ++j) { sd = sd + r.td[j]; su = su + r.tu[j]; }
            f.sd = sd;
            f.su = su;
          }
        });
        // lane 1 finishes the chains and decides
        run([&](int lane, Bc1Lane& r) {
          if (lane == 0) return;
          const float err = chain_on(f.sd, r.td), uerr = chain_on(f.su, r.tu);
          if (!tb_take(err, uerr, f.best, f.best_u)) return;
          int c0, c1;
          float ech[4];
          move_cand<FOUR>(f.q0[ch], f.q1[ch], ch, mv, c0, c1, ech);
          f.best = err;
          f.best_u = uerr;
          f.q0[ch] = c0;
          f.q1[ch] = c1;
        });
      }
    }
  }
}

// d. the cube of one (block, mode) on BC1_CUBE_LANES lanes (a warp):
//   - the red candidates' terms of each pixel into c.rt, (pixel, candidate)
//     dealt to the lanes;
//   - the 81 (green, blue) pairs dealt to the lanes, each with its 9 red
//     candidates, whole in the lane: one pass over the pixels per pair, the
//     pixel's green-blue distances, then its term onto each red candidate's
//     chain (each chain runs over the pixels in order; all lanes read the
//     same red terms at once). Each lane keeps the first smallest of its
//     candidates (lane 0 from the cube's first candidate on, as the
//     sequential loop; the others only below +inf);
//   - lane 0 takes the smallest, the earlier candidate on a tie, and moves
//     the codes.
// With steps = 0 the cube is the start alone, and the codes stay.
template <bool FOUR, bool MASKED, class Run>
__device__ __forceinline__ void bc1_cube(const Bc1Block& b, Bc1Fit& f, const Bc1Budget& bud,
                                         Bc1Cube& c, Run&& run) {
  constexpr int L = BC1_CUBE_LANES, R = BC1_CUBE_SIDE;
  if (cube_steps(bud.passes) == 0) return;
  run([&](int lane) {
#pragma unroll 1
    for (int q = lane; q < 16 * R; q += L) {
      const int p = q / R, jr = q % R;
      float er[4], rt[4];
      int c0, c1;
      cube_cand<FOUR>(f.q0[0], f.q1[0], 0, jr, 1, er, c0, c1);
      cube_red_px<FOUR>(b.xs[0][p], b.w[0], er, rt);
      c.rt[p][jr] = make_float4(rt[0], rt[1], rt[2], rt[3]);
    }
  });
  run([&](int lane) {
    float best = INFINITY;
    int bi = -1;
#pragma unroll 1
    for (int it = lane; it < R * R; it += L) {
      float eg[4], eb[4];
      int c0, c1;
      cube_cand<FOUR>(f.q0[1], f.q1[1], 1, it / R, 1, eg, c0, c1);
      cube_cand<FOUR>(f.q0[2], f.q1[2], 2, it % R, 1, eb, c0, c1);
      float err[R];
      auto pixel = [&](int p, bool first) {
        float gb[4];
        cube_gb_px<FOUR>(b.xs[1][p], b.xs[2][p], b.w, eg, eb, gb);
        const float mp = b.m[p];
#pragma unroll
        for (int jr = 0; jr < R; ++jr) {
          const float4 v = c.rt[p][jr];
          const float rt[4] = {v.x, v.y, v.z, v.w};
          const float d = cube_px<FOUR, MASKED>(gb, rt, mp);
          err[jr] = first ? d : err[jr] + d;
        }
      };
      pixel(0, true);
#pragma unroll 1
      for (int p = 1; p < 16; ++p) pixel(p, false);
#pragma unroll
      for (int jr = 0; jr < R; ++jr) {
        if ((bi < 0 && lane == 0) || err[jr] < best) {
          best = err[jr];
          bi = it * R + jr;
        }
      }
    }
    c.e[lane] = best;
    c.i[lane] = bi;
  });
  run([&](int lane) {
    if (lane) return;
    float best = c.e[0];
    int bi = c.i[0];
#pragma unroll 1
    for (int l = 1; l < L; ++l)
      if (c.i[l] >= 0 && (c.e[l] < best || (c.e[l] == best && c.i[l] < bi))) {
        best = c.e[l];
        bi = c.i[l];
      }
    const int j[3] = {bi % R, bi / (R * R), (bi / R) % R};   // red, green, blue
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float e[4];
      int c0, c1;
      cube_cand<FOUR>(f.q0[ch], f.q1[ch], ch, j[ch], 1, e, c0, c1);
      f.q0[ch] = c0;
      f.q1[ch] = c1;
    }
  });
}

// e. the final assign, split by pixel
template <bool FOUR, bool MASKED, class Run>
__device__ __forceinline__ void bc1_group_assign(const Bc1Block& b, Bc1Fit& f, Run&& run) {
  run([&](int lane, Bc1Lane& r) { group_assign_half<FOUR, MASKED>(b, f, lane, r); });
  run([&](int lane, Bc1Lane& r) {
    if (lane == 0) return;
    f.err = chain_on(f.sd, r.td);
    f.uerr = chain_on(f.su, r.tu);
    f.idx = f.idx0 | r.idx;
  });
}

// The race of the two modes (f3 null: the 4-colour mode alone): the words
// and the error of the block.
template <bool MASKED>
__device__ __forceinline__ void bc1_group_race(const Bc1Block& b, const Bc1Fit& f4,
                                               const Bc1Fit* f3, uint2& words, float& err) {
  uint32_t a0, a1, pidx;
  bc1_order4(f4.q0, f4.q1, f4.idx, a0, a1, pidx);
  err = f4.err;
  if (f3 != nullptr) {
    uint32_t a0_3, a1_3, pidx3;
    bool has_t;
    bc1_order3<MASKED>(f3->q0, f3->q1, f3->idx, b.m, a0_3, a1_3, pidx3, has_t);
    if (!bc1_use4(f4.err, f4.uerr, f3->err, f3->uerr, a0, a1, has_t)) {
      a0 = a0_3;
      a1 = a1_3;
      pidx = pidx3;
      err = f3->err;
    }
  }
  words = make_uint2(a0 | (a1 << 16), pidx);
}

}  // namespace bcx
