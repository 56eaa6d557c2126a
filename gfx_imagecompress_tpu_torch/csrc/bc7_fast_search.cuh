// Fast BC7 search (K4): mode 6 raced against mode 1 over a shortlist of
// partitions, the bc7enc16-style search of kernels/bc7_fast.py.
//
// What bounds it: operations. A block is 256 bytes in, 4*K bytes of ids in
// and 20 bytes out against 10^5 float operations of fits, quantisations and
// exact palette evaluations.
// What the design does about it: one thread per block, the 64 pixel floats in
// registers for the whole search. Metric-space (YCbCr) pixels are recomputed
// from RGB where they are used instead of held. A palette entry is computed
// for the one index a pixel selects, not the whole palette with a select
// chain. The 16 indices of a block travel packed in one 64-bit word, 4 bits
// each, so the anchor read and the index complement are shifts and masks and
// nothing is indexed dynamically. Candidate, variant and partition loops stay
// rolled with one call site per heavy function; pixel and channel loops are
// unrolled. A masked pass visits only the subset's pixels. Blocks with alpha
// skip mode 1, which they could never take.
//
// Bit-agreement with the plain version: candidates in its order, strict <
// (first wins), sums over pixels left to right in pixel order, Python-double
// constants rounded once to float, rintf for half-to-even, no multiply-add
// contraction (build flag).
#pragma once
#include "bc7_common.cuh"

namespace bc7 {

typedef unsigned long long u64;

__device__ __forceinline__ int get4(u64 v, int p) { return (int)((v >> (4 * p)) & 15ull); }

// 16-bit pixel mask -> the same pixels' 4-bit index fields
__device__ __forceinline__ u64 nibble_mask(uint32_t mask) {
  u64 m = 0;
#pragma unroll
  for (int p = 0; p < 16; ++p) m |= ((mask >> p) & 1u) ? (15ull << (4 * p)) : 0ull;
  return m;
}

template <int IB>
__device__ __forceinline__ int weight(int i) {
  return IB == 4 ? weight4(i) : (IB == 3 ? weight3(i) : weight2(i));
}

// interpolation level of index i as a float (w / 64, exact)
template <int IB>
__device__ __forceinline__ float level(int i) {
  return (float)weight<IB>(i) * (1.0f / 64.0f);
}

// number of level midpoints below t: the index of the nearest level
template <int IB>
__device__ __forceinline__ int quantize_t(float t) {
  int idx = 0;
#pragma unroll
  for (int j = 0; j < (1 << IB) - 1; ++j)
    idx += (t > (float)(weight<IB>(j) + weight<IB>(j + 1)) * (1.0f / 128.0f)) ? 1 : 0;
  return idx;
}

// RGB -> metric space: identity, or the integer YCbCr map of bc7enc16's
// compute_color_distance_rgb as one linear map (entries exact in float)
__device__ __forceinline__ void to_metric(bool perc, float r, float g, float b, float* o) {
  if (perc) {
    o[0] = (109.0f / 256.0f) * r + (366.0f / 256.0f) * g + (37.0f / 256.0f) * b;
    o[1] = (403.0f / 256.0f) * r + (-366.0f / 256.0f) * g + (-37.0f / 256.0f) * b;
    o[2] = (-109.0f / 256.0f) * r + (-366.0f / 256.0f) * g + (475.0f / 256.0f) * b;
  } else {
    o[0] = r;
    o[1] = g;
    o[2] = b;
  }
}

__device__ __forceinline__ float metric_weight(bool perc, int c) {
  if (!perc) return 1.0f;
  return c == 0 ? 512.0f : (c == 1 ? 103.0f : (c == 2 ? 18.0f : 128.0f));
}

// ---- projection of a pixel on the segment e0 -> e1
template <int NC>
struct Proj {
  float e0[NC], dirv[NC], inv;
};

template <int NC>
__device__ __forceinline__ void make_proj(const float (&e0)[NC], const float (&e1)[NC],
                                          bool perc, bool weighted, Proj<NC>& pr) {
  float l2 = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float d = e1[c] - e0[c];
    pr.e0[c] = e0[c];
    pr.dirv[c] = weighted ? d * metric_weight(perc, c) : d;
    l2 = l2 + pr.dirv[c] * d;
  }
  pr.inv = l2 > 1e-8f ? 1.0f / fmaxf(l2, 1e-8f) : 0.0f;
}

template <int NC, int IB>
__device__ __forceinline__ int proj_index(const Proj<NC>& pr, const float (&px)[NC]) {
  float t = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) t = t + (px[c] - pr.e0[c]) * pr.dirv[c];
  return quantize_t<IB>(t * pr.inv);
}

// ---- least-squares endpoints for fixed indices over the pixels of `mask`;
// e0/e1 come in as the fallback and stay where the system is singular
template <int NC, int IB>
__device__ __forceinline__ void lsq_refit(const float (&xs)[4][16], u64 idx, uint32_t mask,
                                          float (&e0)[NC], float (&e1)[NC]) {
  float q00 = 0.0f, q01 = 0.0f, q11 = 0.0f;
  float b0[NC], b1[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) b0[c] = b1[c] = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p)
    if ((mask >> p) & 1u) {
      const float a = level<IB>(get4(idx, p));
      const float one_a = 1.0f - a;
      q00 = q00 + one_a * (1.0f - a);
      q01 = q01 + one_a * a;
      q11 = q11 + a * a;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        b0[c] = b0[c] + one_a * xs[c][p];
        b1[c] = b1[c] + a * xs[c][p];
      }
    }
  const float det = q00 * q11 - q01 * q01;
  const bool ok = fabsf(det) > 1e-6f;
  const float inv = 1.0f / (ok ? det : 1.0f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float n0 = (q11 * b0[c] - q01 * b1[c]) * inv;
    const float n1 = (q00 * b1[c] - q01 * b0[c]) * inv;
    e0[c] = ok ? n0 : e0[c];
    e1[c] = ok ? n1 : e1[c];
  }
}

// ---- ones-seeded power iteration on a symmetric covariance, 8 rounds, then
// normalised with `fallback` for a vanishing axis
template <int NC>
__device__ __forceinline__ void principal_axis(const float (&cov)[NC][NC], float fallback,
                                               float (&axis)[NC]) {
  float v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) v[c] = 1.0f;
#pragma unroll 1
  for (int it = 0; it < 8; ++it) {
    float nv[NC];
    float n2 = 0.0f;
#pragma unroll
    for (int a = 0; a < NC; ++a) {
      float acc = 0.0f;
#pragma unroll
      for (int b = 0; b < NC; ++b) acc = acc + cov[a][b] * v[b];
      nv[a] = acc;
      n2 = n2 + acc * acc;
    }
    const float n = sqrtf(n2);
    const bool ok = n > 1e-8f;
    const float inv = 1.0f / fmaxf(n, 1e-8f);
#pragma unroll
    for (int a = 0; a < NC; ++a) v[a] = ok ? nv[a] * inv : v[a];
  }
  float n2 = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) n2 = n2 + v[c] * v[c];
  const float n = sqrtf(n2);
  const bool ok = n > 1e-8f;
  const float inv = 1.0f / fmaxf(n, 1e-8f);
#pragma unroll
  for (int c = 0; c < NC; ++c) axis[c] = ok ? v[c] * inv : fallback;
}

// ---- PCA + least-squares line fit over the pixels of `mask`, `iters`
// least-squares rounds. NC = 4, IB = 4 with the full mask is mode 6's fit;
// NC = 3, IB = 3 a mode-1 subset's. `full` (all 16 pixels) drops the guards
// of an empty extent, which cannot arise then.
template <int NC, int IB>
__device__ __forceinline__ void fit_line(const float (&xs)[4][16], uint32_t mask, bool full,
                                         int iters, float (&e0)[NC], float (&e1)[NC]) {
  const float cnt = full ? 16.0f : fmaxf((float)__popc(mask), 1.0f);
  float mean[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int p = 0; p < 16; ++p)
      if ((mask >> p) & 1u) acc = acc + xs[c][p];
    mean[c] = acc / cnt;
  }
  float cov[NC][NC];
#pragma unroll
  for (int a = 0; a < NC; ++a)
#pragma unroll
    for (int b = a; b < NC; ++b) {
      float acc = 0.0f;
#pragma unroll
      for (int p = 0; p < 16; ++p)
        if ((mask >> p) & 1u) acc = acc + (xs[a][p] - mean[a]) * (xs[b][p] - mean[b]);
      cov[a][b] = acc;
      cov[b][a] = acc;
    }
  float axis[NC];
  principal_axis<NC>(cov, NC == 4 ? 0.5f : 0.57735026f, axis);
  float tmin = full ? INFINITY : 1e30f, tmax = full ? -INFINITY : -1e30f;
#pragma unroll
  for (int p = 0; p < 16; ++p)
    if ((mask >> p) & 1u) {
      float t = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) t = t + (xs[c][p] - mean[c]) * axis[c];
      tmin = fminf(tmin, t);
      tmax = fmaxf(tmax, t);
    }
  if (!full) {
    tmin = tmin > tmax ? 0.0f : tmin;
    tmax = tmax < tmin ? 0.0f : tmax;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    e0[c] = mean[c] + tmin * axis[c];
    e1[c] = mean[c] + tmax * axis[c];
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    Proj<NC> pr;
    make_proj<NC>(e0, e1, false, false, pr);
    u64 idx = 0;
#pragma unroll
    for (int p = 0; p < 16; ++p)
      if ((mask >> p) & 1u) {
        float px[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) px[c] = xs[c][p];
        idx |= (u64)proj_index<NC, IB>(pr, px) << (4 * p);
      }
    lsq_refit<NC, IB>(xs, idx, mask, e0, e1);
  }
}

// ---- endpoint quantisation with a p-bit
template <int BITS>
__device__ __forceinline__ void quant_pbit(float e, int p, int& q, int& deq) {
  constexpr int total = BITS + 1;
  const float wv = e * (float)((double)((1 << total) - 1) / 255.0);
  const float r = rintf((wv - (float)p) * 0.5f);
  q = (int)fminf(fmaxf(r, 0.0f), (float)((1 << BITS) - 1));
  const int full = (q << 1) | p;
  deq = (full << (8 - total)) | (full >> (2 * total - 8));
}

__device__ __forceinline__ float clamp255(float e) { return fminf(fmaxf(e, 0.0f), 255.0f); }

// per-endpoint p-bit of mode 6: the p with the lower rounding error, 0 on a tie
__device__ __forceinline__ void pbit_endpoint(const float (&e)[4], int (&q)[4], int (&d)[4],
                                              int& pbit) {
  int qa[2][4], da[2][4];
  float err[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float ec = clamp255(e[c]);
      quant_pbit<7>(ec, p, qa[p][c], da[p][c]);
      const float diff = (float)da[p][c] - ec;
      acc = acc + diff * diff;
    }
    err[p] = acc;
  }
  const bool take = err[1] < err[0];
  pbit = take ? 1 : 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q[c] = take ? qa[1][c] : qa[0][c];
    d[c] = take ? da[1][c] : da[0][c];
  }
}

// shared p-bit of a mode-1 subset
__device__ __forceinline__ void pbit_shared(const float (&e0)[3], const float (&e1)[3],
                                            int (&q0)[3], int (&d0)[3], int (&q1)[3],
                                            int (&d1)[3], int& pbit) {
  int qa0[2][3], da0[2][3], qa1[2][3], da1[2][3];
  float err[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float a = clamp255(e0[c]), b = clamp255(e1[c]);
      quant_pbit<6>(a, p, qa0[p][c], da0[p][c]);
      quant_pbit<6>(b, p, qa1[p][c], da1[p][c]);
      const float fa = (float)da0[p][c] - a, fb = (float)da1[p][c] - b;
      acc = acc + fa * fa + fb * fb;
    }
    err[p] = acc;
  }
  const bool take = err[1] < err[0];
  pbit = take ? 1 : 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q0[c] = take ? qa0[1][c] : qa0[0][c];
    d0[c] = take ? da0[1][c] : da0[0][c];
    q1[c] = take ? qa1[1][c] : qa1[0][c];
    d1[c] = take ? da1[1][c] : da1[0][c];
  }
}

// ---- exact palette assign in metric space. The index is the quantised
// projection on palette[0] -> palette[last]; the error is the distance to the
// decoder's entry for that index. ALL: every pixel is evaluated, err_in sums
// the pixels of `mask` and err_out the others; otherwise only the pixels of
// `mask` are visited and the other index fields stay 0.
template <int NC, int IB, bool ALL>
__device__ __forceinline__ void assign_exact(const float (&xs)[4][16], bool perc,
                                             const int (&d0)[NC], const int (&d1)[NC],
                                             uint32_t mask, u64& idx, float& err_in,
                                             float& err_out) {
  float p0[NC], p1[NC];
  to_metric(perc, (float)d0[0], (float)d0[1], (float)d0[2], p0);
  to_metric(perc, (float)d1[0], (float)d1[1], (float)d1[2], p1);
  if (NC == 4) {
    p0[NC - 1] = (float)d0[NC - 1];
    p1[NC - 1] = (float)d1[NC - 1];
  }
  Proj<NC> pr;
  make_proj<NC>(p0, p1, perc, true, pr);
  idx = 0;
  err_in = 0.0f;
  err_out = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const bool in = (mask >> p) & 1u;
    if (ALL || in) {
      float ms[NC];
      to_metric(perc, xs[0][p], xs[1][p], xs[2][p], ms);
      if (NC == 4) ms[NC - 1] = xs[3][p];
      const int i = proj_index<NC, IB>(pr, ms);
      const int wk = weight<IB>(i);
      float sel[NC];
      to_metric(perc, (float)lerp64(d0[0], d1[0], wk), (float)lerp64(d0[1], d1[1], wk),
                (float)lerp64(d0[2], d1[2], wk), sel);
      if (NC == 4) sel[NC - 1] = (float)lerp64(d0[NC - 1], d1[NC - 1], wk);
      float d = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float diff = ms[c] - sel[c];
        d = d + metric_weight(perc, c) * diff * diff;
      }
      idx |= (u64)i << (4 * p);
      if (in)
        err_in = err_in + d;
      else
        err_out = err_out + d;
    }
  }
}

// ---- selector variants of the uber machinery. v < 3: the +-1 perturbations
// of the extreme selectors; v >= 3: the selector-scaling extrapolations in
// (ly, hy) order. Returns false for the (0, max_sel) combination, which is
// the identity and is not a variant.
__device__ __forceinline__ bool selector_variant(u64 base, uint32_t mask, int v, int q,
                                                 int max_sel, int mn, int mx, u64& out) {
  out = 0;
  if (v < 3) {
#pragma unroll
    for (int p = 0; p < 16; ++p)
      if ((mask >> p) & 1u) {
        const int r = get4(base, p);
        const bool up = r == mn && r < max_sel;
        const bool dn = r == mx && r > 0;
        int o = r;
        if (v == 0)
          o = up ? r + 1 : r;
        else if (v == 1)
          o = dn ? r - 1 : r;
        else
          o = up ? r + 1 : (dn ? r - 1 : r);
        out |= (u64)o << (4 * p);
      }
    return true;
  }
  const int span = q + 2;
  const int ly = -q + (v - 3) / span;
  const int hy = max_sel - 1 + (v - 3) % span;
  if (ly == 0 && hy == max_sel) return false;
  const float fms = (float)max_sel, fly = (float)ly, fden = (float)(hy - ly);
#pragma unroll
  for (int p = 0; p < 16; ++p)
    if ((mask >> p) & 1u) {
      const float r = (float)get4(base, p);
      const float s = floorf(fms * (r - fly) / fden + 0.5f);
      out |= (u64)(int)fminf(fmaxf(s, 0.0f), fms) << (4 * p);
    }
  return true;
}

// number of variant slots (including the skipped identity) at an uber level
__device__ __forceinline__ int variant_slots(int uber, int& q) {
  q = uber >= 4 ? uber - 2 : 1;
  if (uber <= 0) return 0;
  return 3 + (uber >= 2 ? (q + 2) * (q + 2) : 0);
}

__device__ __forceinline__ void index_extremes(u64 idx, uint32_t mask, int& mn, int& mx) {
  mn = 1 << 20;
  mx = -(1 << 20);
#pragma unroll
  for (int p = 0; p < 16; ++p)
    if ((mask >> p) & 1u) {
      const int r = get4(idx, p);
      mn = min(mn, r);
      mx = max(mx, r);
    }
}

// --------------------------------------------------------------- mode 6 ---
struct State6 {
  float err;
  int q0[4], q1[4], p0, p1;
  u64 idx;
};

__device__ __forceinline__ void mode6(const float (&xs)[4][16], bool perc, int uber,
                                      State6& st) {
  float f0[4], f1[4];
  fit_line<4, 4>(xs, 0xFFFFu, true, 2, f0, f1);
  int q;
  const int nsteps = 2 + variant_slots(uber, q);
  u64 base = 0;
  int mn = 0, mx = 0;
  st.err = 0.0f;
  // step 0: the initial fit; step 1: a refit from the winner's indices;
  // steps 2..: refits from the variants of the indices after step 1. Every
  // refit falls back to the initial fit.
#pragma unroll 1
  for (int step = 0; step < nsteps; ++step) {
    float e0[4], e1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      e0[c] = f0[c];
      e1[c] = f1[c];
    }
    if (step >= 1) {
      u64 src = st.idx;
      if (step >= 2) {
        if (step == 2) {
          base = st.idx;
          index_extremes(base, 0xFFFFu, mn, mx);
        }
        if (!selector_variant(base, 0xFFFFu, step - 2, q, 15, mn, mx, src)) continue;
      }
      lsq_refit<4, 4>(xs, src, 0xFFFFu, e0, e1);
    }
    State6 c;
    int d0[4], d1[4];
    pbit_endpoint(e0, c.q0, d0, c.p0);
    pbit_endpoint(e1, c.q1, d1, c.p1);
    float unused;
    assign_exact<4, 4, true>(xs, perc, d0, d1, 0xFFFFu, c.idx, c.err, unused);
    if (step == 0 || c.err < st.err) st = c;
  }
}

// ---- 128-bit block as two 64-bit halves
struct Bits128 {
  u64 lo, hi;
};

__device__ __forceinline__ void put(Bits128& b, int val, int pos, int nb) {
  const u64 v = (u64)((uint32_t)val & ((1u << nb) - 1u));
  if (pos < 64) {
    b.lo |= v << pos;
    if (pos + nb > 64) b.hi |= v >> (64 - pos);
  } else {
    b.hi |= v << (pos - 64);
  }
}

__device__ __forceinline__ Bits128 pack_mode6(const State6& st) {
  // anchor fix-up: the index MSB of pixel 0 must be 0
  const bool need = (get4(st.idx, 0) & 8) != 0;
  const u64 idx = need ? ~st.idx : st.idx;          // 15 - i in every field
  Bits128 b = {0ull, 0ull};
  put(b, 0x40, 0, 8);
  int pos = 7;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    put(b, need ? st.q1[c] : st.q0[c], pos, 7);
    put(b, need ? st.q0[c] : st.q1[c], pos + 7, 7);
    pos += 14;
  }
  put(b, need ? st.p1 : st.p0, 63, 1);
  put(b, need ? st.p0 : st.p1, 64, 1);
  pos = 65;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int nb = p == 0 ? 3 : 4;
    put(b, get4(idx, p), pos, nb);
    pos += nb;
  }
  return b;
}

// --------------------------------------------------------------- mode 1 ---
struct Subset1 {
  float err;
  int q0[3], q1[3], pb;
};

struct State1 {
  float err;
  int pid;
  u64 idx;
  Subset1 s[2];
};

// 6-bit endpoints + shared p-bit for the pixels of `mask`, one exact assign
__device__ __forceinline__ void quant1_subset(const float (&xs)[4][16], bool perc,
                                              uint32_t mask, const float (&e0)[3],
                                              const float (&e1)[3], Subset1& out, u64& idx) {
  int d0[3], d1[3];
  pbit_shared(e0, e1, out.q0, d0, out.q1, d1, out.pb);
  float unused;
  assign_exact<3, 3, false>(xs, perc, d0, d1, mask, idx, out.err, unused);
}

__device__ __forceinline__ int expand7(int q, int pb) {
  const int x = ((q << 1) | pb) << 1;
  return x | (x >> 7);
}

// whole-block single-colour candidate: partition 0, both subsets the optimal
// table endpoints of the block's mean colour (raw = per-channel sums of the
// unscaled pixels)
__device__ __forceinline__ void solid_candidate(const float (&xs)[4][16], bool perc,
                                                const float (&raw)[3], State1& out) {
  int cv[3];
  int e[2] = {0, 0};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    cv[c] = (int)fminf(fmaxf(rintf(raw[c] / 16.0f * 255.0f), 0.0f), 255.0f);
    e[0] += (int)(SOLID1[2 * cv[c]] >> 16);
    e[1] += (int)(SOLID1[2 * cv[c] + 1] >> 16);
  }
  const int pb = e[1] < e[0] ? 1 : 0;
  int d0[3], d1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint32_t t = SOLID1[2 * cv[c] + pb];
    out.s[0].q0[c] = out.s[1].q0[c] = (int)(t & 0xFFu);
    out.s[0].q1[c] = out.s[1].q1[c] = (int)((t >> 8) & 0xFFu);
    d0[c] = expand7(out.s[0].q0[c], pb);
    d1[c] = expand7(out.s[0].q1[c], pb);
  }
  out.s[0].pb = out.s[1].pb = pb;
  out.pid = 0;
  assign_exact<3, 3, true>(xs, perc, d0, d1, ~P2[0] & 0xFFFFu, out.idx, out.s[0].err,
                           out.s[1].err);
  out.err = out.s[0].err + out.s[1].err;
}

__device__ __forceinline__ void mode1(const float (&xs)[4][16], bool perc, int uber,
                                      const float (&raw)[3], const int* __restrict__ ids,
                                      int nids, State1& st) {
  st.err = 0.0f;
#pragma unroll 1
  for (int k = 0; k < nids; ++k) {
    State1 c;
    c.pid = ids[k];
    c.idx = 0;
    const uint32_t bits = P2[c.pid];
#pragma unroll 1
    for (int s = 0; s < 2; ++s) {
      const uint32_t mask = s ? (bits & 0xFFFFu) : (~bits & 0xFFFFu);
      float e0[3], e1[3];
      fit_line<3, 3>(xs, mask, false, 2, e0, e1);
      Subset1 sub;
      u64 idx;
      quant1_subset(xs, perc, mask, e0, e1, sub, idx);
      c.idx |= idx;
      if (s == 0)
        c.s[0] = sub;
      else
        c.s[1] = sub;
    }
    c.err = c.s[0].err + c.s[1].err;
    if (k == 0 || c.err < st.err) st = c;
  }
  {
    State1 c;
    solid_candidate(xs, perc, raw, c);
    if (c.err < st.err) st = c;
  }
  int q;
  const int nvar = variant_slots(uber, q);
  if (nvar == 0) return;
  // uber rounds on the winner's subsets: the variants of a subset derive from
  // the indices at entry to that subset's loop (subset 1 sees subset 0's
  // result); the least-squares fallback is the entry winner's endpoints
  const uint32_t bits = P2[st.pid];
#pragma unroll 1
  for (int s = 0; s < 2; ++s) {
    const uint32_t mask = s ? (bits & 0xFFFFu) : (~bits & 0xFFFFu);
    const u64 nib = nibble_mask(mask);
    Subset1 best = s ? st.s[1] : st.s[0];
    float d0[3], d1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d0[c] = (float)expand7(best.q0[c], best.pb);
      d1[c] = (float)expand7(best.q1[c], best.pb);
    }
    const u64 base = st.idx;
    u64 best_idx = base & nib;
    int mn, mx;
    index_extremes(base, mask, mn, mx);
#pragma unroll 1
    for (int v = 0; v < nvar; ++v) {
      u64 src;
      if (!selector_variant(base, mask, v, q, 7, mn, mx, src)) continue;
      float e0[3], e1[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        e0[c] = d0[c];
        e1[c] = d1[c];
      }
      lsq_refit<3, 3>(xs, src, mask, e0, e1);
      Subset1 cand;
      u64 idx;
      quant1_subset(xs, perc, mask, e0, e1, cand, idx);
      if (cand.err < best.err) {
        best = cand;
        best_idx = idx;
      }
    }
    st.idx = (base & ~nib) | best_idx;
    if (s == 0)
      st.s[0] = best;
    else
      st.s[1] = best;
  }
  st.err = st.s[0].err + st.s[1].err;
}

__device__ __forceinline__ Bits128 pack_mode1(const State1& st) {
  const int anchor = ANCHOR2[st.pid];
  const u64 nib1 = nibble_mask(P2[st.pid] & 0xFFFFu);       // subset 1's fields
  u64 idx = st.idx;
  // subset-0 fix-up (anchor pixel 0), then subset 1's (anchor pixel of the shape)
  const bool need0 = (get4(idx, 0) & 4) != 0;
  if (need0) idx ^= 0x7777777777777777ull & ~nib1;          // 7 - i
  const bool need1 = (get4(idx, anchor) & 4) != 0;
  if (need1) idx ^= 0x7777777777777777ull & nib1;
  Bits128 b = {0ull, 0ull};
  put(b, 2, 0, 2);
  put(b, st.pid, 2, 6);
  int pos = 8;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    put(b, need0 ? st.s[0].q1[c] : st.s[0].q0[c], pos, 6);
    put(b, need0 ? st.s[0].q0[c] : st.s[0].q1[c], pos + 6, 6);
    put(b, need1 ? st.s[1].q1[c] : st.s[1].q0[c], pos + 12, 6);
    put(b, need1 ? st.s[1].q0[c] : st.s[1].q1[c], pos + 18, 6);
    pos += 24;
  }
  put(b, st.s[0].pb, 80, 1);
  put(b, st.s[1].pb, 81, 1);
  // pixel 0 and the anchor pixel store one index bit fewer
  pos = 82;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int nb = 3 - (p == 0 ? 1 : 0) - (p == anchor ? 1 : 0);
    put(b, get4(idx, p), pos, nb);
    pos += nb;
  }
  return b;
}

// ---- one block: mode 6, and for an opaque block mode 1 raced against it.
// xs: the block scaled to 0..255; raw: per-channel sums of the unscaled RGB.
__device__ __forceinline__ void fast_search(const float (&xs)[4][16], const float (&raw)[3],
                                            const int* __restrict__ ids, int nids, bool perc,
                                            int uber, Bits128& out, float& err) {
  float amin = xs[3][0];
#pragma unroll
  for (int p = 1; p < 16; ++p) amin = fminf(amin, xs[3][p]);
  State6 st6;
  mode6(xs, perc, uber, st6);
  out = pack_mode6(st6);
  err = st6.err;
  if (amin < 254.999f) return;       // a block with alpha takes mode 6
  State1 st1;
  mode1(xs, perc, uber, raw, ids, nids, st1);
  if (st1.err < st6.err) {
    out = pack_mode1(st1);
    err = st1.err;
  }
}

}  // namespace bc7
