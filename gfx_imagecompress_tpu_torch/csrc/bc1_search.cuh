// BC1 colour search for one 4x4 block, one thread.
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
// hundred thousand f32/i32 operations. The design keeps the 48 colour floats
// of a block (plus 16 mask floats on the punch-through path) in the registers
// of one thread for the whole search and writes only the packed words and the
// error. Everything that indexes the pixel or channel arrays is unrolled so
// the arrays stay in registers; candidate loops stay rolled to bound code
// size. The joint cube (b3d) keeps only the 108 candidate palette values per
// mode in local memory and recomputes distances, instead of tabulating 1,728
// per-pixel distances per block as the row-vector version does.
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

__device__ __forceinline__ bool tb_take(float werr, float uerr, float best_w, float best_u) {
  const bool win = werr < best_w * BC1_TB_LO;
  const bool tie = (werr <= best_w * BC1_TB_HI) && (uerr < best_u);
  return win || tie;
}

// Nearest palette entry of every pixel under the weighted distance (first
// wins on equality): 2-bit indices packed LSB first, the weighted error and
// the unweighted error of that assignment. Masked pixels cost nothing.
template <bool FOUR, bool MASKED>
__device__ __forceinline__ void bc1_eval(const float (&xs)[3][16], const float (&m)[16],
                                         const float (&w)[3], const int (&q0)[3],
                                         const int (&q1)[3], uint32_t& idx, float& err,
                                         float& uerr) {
  constexpr int K = FOUR ? 4 : 3;
  float pal[3][4];
#pragma unroll
  for (int c = 0; c < 3; ++c) chan_palette<FOUR>(q0[c], q1[c], c, pal[c]);
  idx = 0u;
  err = 0.0f;
  uerr = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    float best_d = 0.0f, best_u = 0.0f;
    uint32_t bi = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float d = 0.0f, u = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float diff = xs[c][p] - pal[c][k];
        d = d + (w[c] * diff) * diff;
        u = u + diff * diff;
      }
      if (k == 0 || d < best_d) { best_d = d; best_u = u; bi = (uint32_t)k; }
    }
    if (MASKED) { best_d = best_d * m[p]; best_u = best_u * m[p]; }
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

// Sequential per-channel +/-1 jitter of the 565 endpoints under the exact
// integer palette, with the unweighted tie-break.
template <bool FOUR, bool MASKED>
__device__ __forceinline__ void bc1_refine(const float (&xs)[3][16], const float (&m)[16],
                                           const float (&w)[3], int passes, int (&q0)[3],
                                           int (&q1)[3]) {
  constexpr int K = FOUR ? 4 : 3;
  uint32_t idx_unused;
  float best, best_u;
  bc1_eval<FOUR, MASKED>(xs, m, w, q0, q1, idx_unused, best, best_u);
#pragma unroll 1
  for (int pass = 0; pass < passes; ++pass) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int maxq = (ch == 1) ? 63 : 31;
      // distance to each palette entry over the two channels that stay
      float od[4][16], ou[4][16];
      {
        float pal[3][4];
#pragma unroll
        for (int c = 0; c < 3; ++c) chan_palette<FOUR>(q0[c], q1[c], c, pal[c]);
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
          for (int p = 0; p < 16; ++p) {
            float d = 0.0f, u = 0.0f;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              if (c != ch) {
                const float diff = xs[c][p] - pal[c][k];
                d = d + (w[c] * diff) * diff;
                u = u + diff * diff;
              }
            }
            od[k][p] = d;
            ou[k][p] = u;
          }
        }
      }
#pragma unroll 1
      for (int mv = 0; mv < 9; ++mv) {
        if (mv == 4) continue;                       // (0, 0)
        const int d0 = mv / 3 - 1, d1 = mv % 3 - 1;
        const int c0 = clamp_i(q0[ch] + d0, 0, maxq);
        const int c1 = clamp_i(q1[ch] + d1, 0, maxq);
        float ech[4];
        chan_palette<FOUR>(c0, c1, ch, ech);
        float err = 0.0f, uerr = 0.0f;
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          float dbest = 0.0f, ubest = 0.0f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float diff = xs[ch][p] - ech[k];
            const float dk = od[k][p] + (w[ch] * diff) * diff;
            const float uk = ou[k][p] + diff * diff;
            if (k == 0 || dk < dbest) { dbest = dk; ubest = uk; }
          }
          if (MASKED) { dbest = dbest * m[p]; ubest = ubest * m[p]; }
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

// Joint 3-channel endpoint cube (Refine3D): all (2*steps+1)^6 simultaneous
// moves of the six 565 components, green outermost, then blue, then red.
template <bool FOUR, bool MASKED>
__device__ __forceinline__ void bc1_refine3d(const float (&xs)[3][16], const float (&m)[16],
                                             const float (&w)[3], int steps, int (&q0)[3],
                                             int (&q1)[3]) {
  constexpr int K = FOUR ? 4 : 3;
  steps = steps < 1 ? (steps < 0 ? 0 : steps) : 1;
  const int side = 2 * steps + 1;
  const int ncomb = side * side;                     // moves of one channel
  float E[3][9][4];                                  // candidate palettes
  int Q0[3][9], Q1[3][9];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int maxq = (c == 1) ? 63 : 31;
#pragma unroll 1
    for (int j = 0; j < ncomb; ++j) {
      const int d0 = j / side - steps, d1 = j % side - steps;
      const int c0 = clamp_i(q0[c] + d0, 0, maxq);
      const int c1 = clamp_i(q1[c] + d1, 0, maxq);
      chan_palette<FOUR>(c0, c1, c, E[c][j]);
      Q0[c][j] = c0;
      Q1[c][j] = c1;
    }
  }
  float best = 0.0f;
  int br = 0, bg = 0, bb = 0;
  bool first = true;
#pragma unroll 1
  for (int jg = 0; jg < ncomb; ++jg) {
#pragma unroll 1
    for (int jb = 0; jb < ncomb; ++jb) {
      float gb[4][16];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float eg = E[1][jg][k], eb = E[2][jb][k];
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          const float rg = xs[1][p] - eg, rb = xs[2][p] - eb;
          gb[k][p] = w[1] * (rg * rg) + w[2] * (rb * rb);
        }
      }
#pragma unroll 1
      for (int jr = 0; jr < ncomb; ++jr) {
        float er[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) er[k] = E[0][jr][k];
        float err = 0.0f;
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          float dbest = 0.0f;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float rr = xs[0][p] - er[k];
            const float dk = gb[k][p] + w[0] * (rr * rr);
            dbest = (k == 0) ? dk : fminf(dbest, dk);
          }
          if (MASKED) dbest = dbest * m[p];
          err = (p == 0) ? dbest : err + dbest;
        }
        if (first || err < best) {
          first = false;
          best = err;
          br = jr;
          bg = jg;
          bb = jb;
        }
      }
    }
  }
  q0[0] = Q0[0][br]; q1[0] = Q1[0][br];
  q0[1] = Q0[1][bg]; q1[1] = Q1[1][bg];
  q0[2] = Q0[2][bb]; q1[2] = Q1[2][bb];
}

// One mode (4-colour or 3-colour) of the search: PCA axis, endpoint-position
// sweep, two least-squares fits, 565 quantise, refinement, final assignment.
template <bool FOUR, bool MASKED>
__device__ __forceinline__ void bc1_fit_mode(const float (&xs)[3][16], const float (&m)[16],
                                             const float (&w)[3], int iters, int passes,
                                             bool b3d, int (&q0)[3], int (&q1)[3],
                                             uint32_t& idx, float& err, float& uerr) {
  constexpr int K = FOUR ? 4 : 3;
  const float lv[4] = {0.0f, FOUR ? (float)(1.0 / 3.0) : 0.5f,
                       FOUR ? (float)(2.0 / 3.0) : 1.0f, 1.0f};
  const float mids[3] = {
      FOUR ? (float)((0.0 + 1.0 / 3.0) * 0.5) : (float)((0.0 + 0.5) * 0.5),
      FOUR ? (float)((1.0 / 3.0 + 2.0 / 3.0) * 0.5) : (float)((0.5 + 1.0) * 0.5),
      (float)((2.0 / 3.0 + 1.0) * 0.5)};

  // ---- PCA axis (power iteration seeded with ones)
  float mean[3], axis[3];
  {
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
    const float n = sqrtf(v0 * v0 + v1 * v1 + v2 * v2);
    const bool ok = n > BC1_EPS;
    const float inv = 1.0f / fmaxf(n, BC1_EPS);
    axis[0] = ok ? v0 * inv : BC1_UNIT3;
    axis[1] = ok ? v1 * inv : BC1_UNIT3;
    axis[2] = ok ? v2 * inv : BC1_UNIT3;
  }

  // ---- projections and their (masked) extents
  float lo_c[2], hi_c[2];                             // bounds start, sweep start
  {
    float t[16];
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

    // ---- endpoint-position sweep along the axis: 4x4 coarse, 3x3 fine
    const float span = tmax - tmin;
    const float scl0 = tmin - span * 0.125f;
    const float s = span * 1.25f;
    const float cl[4] = {(float)(0.05 + 0 * 0.025), (float)(0.05 + 2 * 0.025),
                         (float)(0.05 + 4 * 0.025), (float)(0.05 + 6 * 0.025)};
    const float chh[4] = {(float)(0.95 - 0 * 0.025), (float)(0.95 - 2 * 0.025),
                          (float)(0.95 - 4 * 0.025), (float)(0.95 - 6 * 0.025)};
    float be = 0.0f, blo = 0.0f, bhi = 0.0f;
#pragma unroll 1
    for (int i = 0; i < 16; ++i) {
      const int l = i >> 2, h = i & 3;
      const float fl = (l == 0) ? cl[0] : (l == 1) ? cl[1] : (l == 2) ? cl[2] : cl[3];
      const float fh = (h == 0) ? chh[0] : (h == 1) ? chh[1] : (h == 2) ? chh[2] : chh[3];
      const float lo = scl0 + fl * s;
      const float hi = scl0 + fh * s;
      const float e = ramp_err<FOUR, MASKED>(t, m, lv, lo, hi);
      if (i == 0 || e < be) { be = e; blo = lo; bhi = hi; }
    }
    const float stp = (float)(0.025) * s;
    const float lo0 = blo, hi0 = bhi;
#pragma unroll 1
    for (int i = 0; i < 9; ++i) {
      if (i == 4) continue;
      const float dl = (float)(i / 3 - 1), dh = (float)(i % 3 - 1);
      const float lo = lo0 + dl * stp;
      const float hi = hi0 + dh * stp;
      const float e = ramp_err<FOUR, MASKED>(t, m, lv, lo, hi);
      if (e < be) { be = e; blo = lo; bhi = hi; }
    }
    lo_c[0] = tmin; hi_c[0] = tmax;
    lo_c[1] = blo;  hi_c[1] = bhi;
  }

  // ---- two least-squares fits, quantise, keep the better
  float best_e = 0.0f;
#pragma unroll 1
  for (int cand = 0; cand < 2; ++cand) {
    const float lo = cand ? lo_c[1] : lo_c[0];
    const float hi = cand ? hi_c[1] : hi_c[0];
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
    int c0[3], c1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float maxq = (c == 1) ? 63.0f : 31.0f;
      const float scale = (c == 1) ? (float)(63 / 255.0) : (float)(31 / 255.0);
      c0[c] = (int)fminf(fmaxf(rintf(e0[c] * scale), 0.0f), maxq);
      c1[c] = (int)fminf(fmaxf(rintf(e1[c] * scale), 0.0f), maxq);
    }
    uint32_t idx_unused;
    float e, u_unused;
    bc1_eval<FOUR, MASKED>(xs, m, w, c0, c1, idx_unused, e, u_unused);
    if (cand == 0 || e < best_e) {
      best_e = e;
#pragma unroll
      for (int c = 0; c < 3; ++c) { q0[c] = c0[c]; q1[c] = c1[c]; }
    }
  }

  if (b3d) bc1_refine3d<FOUR, MASKED>(xs, m, w, passes, q0, q1);
  else bc1_refine<FOUR, MASKED>(xs, m, w, passes, q0, q1);
  bc1_eval<FOUR, MASKED>(xs, m, w, q0, q1, idx, err, uerr);
}

// Full search. xs in 0..255; m is the opaque mask (read only if MASKED).
// Returns the two 565 endpoint words in their final order, the 2-bit indices
// (remaps applied, transparent pixels on index 3) and the weighted error.
template <bool MASKED>
__device__ __forceinline__ void bc1_search(const float (&xs)[3][16], const float (&m)[16],
                                           const Bc1Budget& bud, uint32_t& a0, uint32_t& a1,
                                           uint32_t& pidx, float& err) {
  float w[3] = {bud.w[0], bud.w[1], bud.w[2]};
  if (bud.adaptive) {
    // mean-channel skew applied to the base weights
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
    for (int c = 0; c < 3; ++c)
      w[c] = (bud.w[c] * (3.0f * mc[c] / largest + 1.0f)) * 0.25f;
    const float s = w[0] + w[1] + w[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) w[c] = w[c] / s;
  }

  int q0[3], q1[3];
  uint32_t idx4;
  float err4, uerr4;
  bc1_fit_mode<true, MASKED>(xs, m, w, bud.iters, bud.passes, bud.b3d != 0, q0, q1, idx4,
                             err4, uerr4);
  const uint32_t c0_4 = ((uint32_t)q0[0] << 11) | ((uint32_t)q0[1] << 5) | (uint32_t)q0[2];
  const uint32_t c1_4 = ((uint32_t)q1[0] << 11) | ((uint32_t)q1[1] << 5) | (uint32_t)q1[2];
  const bool swap4 = c0_4 < c1_4;
  const uint32_t a0_4 = swap4 ? c1_4 : c0_4;
  const uint32_t a1_4 = swap4 ? c0_4 : c1_4;
  const uint32_t pidx4 = swap4 ? (idx4 ^ 0x55555555u) : idx4;   // [1,0,3,2]
  if (!bud.allow_three) {
    a0 = a0_4; a1 = a1_4; pidx = pidx4; err = err4;
    return;
  }
  const bool degenerate4 = a0_4 == a1_4;

  uint32_t idx3;
  float err3, uerr3;
  bc1_fit_mode<false, MASKED>(xs, m, w, bud.iters, bud.passes, bud.b3d != 0, q0, q1, idx3,
                              err3, uerr3);
  const uint32_t c0_3 = ((uint32_t)q0[0] << 11) | ((uint32_t)q0[1] << 5) | (uint32_t)q0[2];
  const uint32_t c1_3 = ((uint32_t)q1[0] << 11) | ((uint32_t)q1[1] << 5) | (uint32_t)q1[2];
  const bool swap3 = c0_3 > c1_3;
  const uint32_t a0_3 = swap3 ? c1_3 : c0_3;
  const uint32_t a1_3 = swap3 ? c0_3 : c1_3;
  uint32_t pidx3 = 0u;
  bool has_t = false;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    uint32_t i = (idx3 >> (2 * p)) & 3u;
    if (swap3 && i < 2u) i ^= 1u;                    // [1,0,2,3]
    if (MASKED && !(m[p] > 0.5f)) { i = 3u; has_t = true; }
    pidx3 |= i << (2 * p);
  }
  const bool use4 = tb_take(err4, uerr4, err3, uerr3) && !degenerate4 && !has_t;
  a0 = use4 ? a0_4 : a0_3;
  a1 = use4 ? a1_4 : a1_3;
  pidx = use4 ? pidx4 : pidx3;
  err = use4 ? err4 : err3;
}

}  // namespace bcx
