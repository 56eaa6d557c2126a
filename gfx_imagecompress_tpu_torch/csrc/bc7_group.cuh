// What the two lane-group BC7 searches share: the fast search (K4,
// bc7_fast_search.cuh) and the full search (K5, bc7_full_search.cuh). The
// BC6H search (K6, bc6h_search.cuh) takes the scan and the phase runner.
//
// - The projection, least-squares and principal-axis arithmetic of the
//   plain versions (kernels/bc7_fast.py, kernels/bc7_full.py), in their order.
// - The masked passes over a subset's pixels, read from the group's shared
//   copy of the block by index: fit_sub (PCA + least-squares line fit),
//   refit_sub (least squares for fixed indices), assign_sub (exact palette
//   assign, RGB(A) metric or the perceptual one) and sel_variant (the uber
//   selector variants). One implementation of each serves both searches.
// - The states a candidate leaves in a slot (Sub, Slot, Entry, Chain) and
//   scan_min, the in-order strict-< scan that picks a phase's winner from
//   the slots with the sequential loop's compares.
// - GroupRun, the phase runner of a group of lanes inside one warp: a phase
//   is a function of the lane, run on each lane and followed by the group's
//   barrier. The host build of the tests runs a phase as a loop over the
//   lanes instead.
//
// Bit-agreement with the plain versions: sums over pixels left to right in
// pixel order, Python-double constants rounded once to float, rintf for
// half-to-even, no multiply-add contraction (build flag).
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
  return bcx::i2f(weight<IB>(i)) * (1.0f / 64.0f);
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

// endpoint codes, 8 bits per channel in one word
__device__ __forceinline__ int getq(uint32_t q, int c) { return (int)((q >> (8 * c)) & 255u); }
__device__ __forceinline__ void setq(uint32_t& q, int c, int v) {
  q = (q & ~(255u << (8 * c))) | ((uint32_t)v << (8 * c));
}

// ---- the states candidates leave in the group's shared memory
struct Sub {       // endpoints and error of one subset
  float err;
  uint32_t q0, q1;  // codes per channel
  int p0, p1;       // p-bits (0 without; a shared p-bit in both)
};

struct Slot {      // one candidate's result in a phase's slot
  u64 idx;         // the subset's index fields only
  Sub s;
  int ok;          // 0: a skipped variant
};

struct Entry {     // a refinement group at the entry of its uber phase
  Sub s;           // its state there
  u64 base;        // its index fields there
  uint32_t mask;
  int mn, mx;      // smallest and largest index there
};

template <int S>
struct Chain {     // a partition's candidate: per subset its state and fields
  float err;
  int pid;
  Sub s[S];
  u64 idx[S];
};

// A strict-< scan of candidates 0..n-1 against an incumbent error `inc`: a
// candidate with ok(t) false is skipped, the incumbent and then the earlier
// candidate keep ties. Returns the winning candidate, or -1 where the
// incumbent stays; `inc` ends as the winner's error.
template <class Err, class Ok>
__device__ __forceinline__ int scan_min(float& inc, int n, Err err, Ok ok) {
  int w = -1;
  for (int t = 0; t < n; ++t) {
    const float e = err(t);
    if (ok(t) && e < inc) {
      inc = e;
      w = t;
    }
  }
  return w;
}

template <class Err>
__device__ __forceinline__ int scan_min(float& inc, int n, Err err) {
  return scan_min(inc, n, err, [](int) { return true; });
}

// The uber scan of group g over a chunk of slots: the group's items are the
// contiguous run [g * nvar, (g + 1) * nvar) of the phase, this chunk holds
// [t0, t0 + nt). Strict < against the group's running state (the entry
// first), skipped variants passed over.
__device__ __forceinline__ void uber_pick(const Slot* slot, int t0, int nt, int g, int nvar,
                                          Sub& st, u64& idx) {
  const int lo = max(g * nvar, t0) - t0, hi = min((g + 1) * nvar, t0 + nt) - t0;
  const Slot* sl = slot + lo;
  float inc = st.err;
  const int w = scan_min(inc, hi - lo, [&](int i) { return sl[i].s.err; },
                         [&](int i) { return sl[i].ok != 0; });
  if (w >= 0) {
    st = sl[w].s;
    idx = sl[w].idx;
  }
}

// ---- masked passes over the subset's pixels, ascending, the pixels read
// from the group's shared copy by index.
// FULL: the mask is all 16 pixels, known at compile time (the one-subset
// modes); the pass is then a counted loop, kept rolled: unrolled 2, 4, 8 or
// 16 times, the dual modes' kernels run 1.2-2.2 times slower on the H100
// (code size; PERF.md).
template <bool FULL, class F>
__device__ __forceinline__ void for_pixels(uint32_t mask, F&& f) {
  if constexpr (FULL) {
#pragma unroll 1
    for (int p = 0; p < 16; ++p) f(p);
  } else {
    for (uint32_t m = mask; m; m &= m - 1) f(__ffs(m) - 1);
  }
}

// least-squares endpoints for fixed indices; e0/e1 come in as the fallback
// and stay where the system is singular
template <int NC, int IB, bool FULL, class X>
__device__ __forceinline__ void refit_sub(const X& xs, u64 idx, uint32_t mask,
                                          float (&e0)[NC], float (&e1)[NC]) {
  float q00 = 0.0f, q01 = 0.0f, q11 = 0.0f;
  float b0[NC], b1[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) b0[c] = b1[c] = 0.0f;
  for_pixels<FULL>(mask, [&](int p) {
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
  });
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

// PCA + least-squares line fit over the pixels of `mask`, `iters` rounds.
// NC = 4, IB = 4 over all 16 pixels is mode 6's fit; NC = 3 over a subset a
// two- or three-subset mode's.
template <int NC, int IB, bool FULL, class X>
__device__ __forceinline__ void fit_sub(const X& xs, uint32_t mask, int iters,
                                        float (&e0)[NC], float (&e1)[NC]) {
  const float cnt = fmaxf((float)__popc(mask), 1.0f);
  float mean[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) mean[c] = 0.0f;
  for_pixels<FULL>(mask, [&](int p) {
#pragma unroll
    for (int c = 0; c < NC; ++c) mean[c] = mean[c] + xs[c][p];
  });
#pragma unroll
  for (int c = 0; c < NC; ++c) mean[c] = mean[c] / cnt;
  float cov[NC][NC];
#pragma unroll
  for (int a = 0; a < NC; ++a)
#pragma unroll
    for (int b = a; b < NC; ++b) cov[a][b] = 0.0f;
  for_pixels<FULL>(mask, [&](int p) {
    float d[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) d[c] = xs[c][p] - mean[c];
#pragma unroll
    for (int a = 0; a < NC; ++a)
#pragma unroll
      for (int b = a; b < NC; ++b) cov[a][b] = cov[a][b] + d[a] * d[b];
  });
#pragma unroll
  for (int a = 0; a < NC; ++a)
#pragma unroll
    for (int b = 0; b < a; ++b) cov[a][b] = cov[b][a];
  float axis[NC];
  principal_axis<NC>(cov, NC == 4 ? 0.5f : 0.57735026f, axis);
  float tmin = 1e30f, tmax = -1e30f;
  for_pixels<FULL>(mask, [&](int p) {
    float t = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) t = t + (xs[c][p] - mean[c]) * axis[c];
    tmin = fminf(tmin, t);
    tmax = fmaxf(tmax, t);
  });
  tmin = tmin > tmax ? 0.0f : tmin;
  tmax = tmax < tmin ? 0.0f : tmax;
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
    for_pixels<FULL>(mask, [&](int p) {
      float px[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) px[c] = xs[c][p];
      idx |= (u64)proj_index<NC, IB>(pr, px) << (4 * p);
    });
    refit_sub<NC, IB, FULL>(xs, idx, mask, e0, e1);
  }
}

// Exact palette assign of the pixels of `mask`, channels C0..C0+NC-1: the
// projection index, the distance to the entry it selects; index fields
// outside the mask stay 0. w (unless null): the weight of the entry each
// pixel of the mask selects, at the pixel's position.
// PERC: bc7enc16's perceptual metric (the fast search's default): the pixel
// and the selected entry mapped to YCbCr (to_metric; alpha, the fourth
// channel, raw), the projection weighted and the distance the weighted sum
// metric_weight(c) * diff * diff, left to right over the channels. Without
// it, plain RGB(A) distances.
template <int NC, int C0, int IB, bool FULL, bool PERC = false, class X>
__device__ __forceinline__ void assign_sub(const X& xs, const int (&d0)[NC],
                                           const int (&d1)[NC], uint32_t mask, u64& idx,
                                           float& err, uint8_t* w = nullptr) {
  static_assert(C0 == 0 || (NC == 1 && C0 == 3), "a scalar assign reads the alpha row");
  static_assert(!PERC || (C0 == 0 && NC >= 3), "the perceptual metric maps RGB");
  float p0[NC], p1[NC];
  if constexpr (PERC) {
    to_metric(true, bcx::i2f(d0[0]), bcx::i2f(d0[1]), bcx::i2f(d0[2]), p0);
    to_metric(true, bcx::i2f(d1[0]), bcx::i2f(d1[1]), bcx::i2f(d1[2]), p1);
    if constexpr (NC == 4) {
      p0[3] = bcx::i2f(d0[3]);
      p1[3] = bcx::i2f(d1[3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      p0[c] = bcx::i2f(d0[c]);
      p1[c] = bcx::i2f(d1[c]);
    }
  }
  Proj<NC> pr;
  make_proj<NC>(p0, p1, PERC, true, pr);
  u64 acc = 0;
  float e = 0.0f;
  for_pixels<FULL>(mask, [&](int p) {
    float px[NC];
    if constexpr (PERC) {
      to_metric(true, xs[0][p], xs[1][p], xs[2][p], px);
      if constexpr (NC == 4) px[3] = xs[3][p];
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) px[c] = xs[C0 + c][p];
    }
    const int i = proj_index<NC, IB>(pr, px);
    const int wk = weight<IB>(i);
    float d = 0.0f;
    if constexpr (PERC) {
      float sel[NC];
      to_metric(true, bcx::i2f(lerp64(d0[0], d1[0], wk)), bcx::i2f(lerp64(d0[1], d1[1], wk)),
                bcx::i2f(lerp64(d0[2], d1[2], wk)), sel);
      if constexpr (NC == 4) sel[3] = bcx::i2f(lerp64(d0[3], d1[3], wk));
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float diff = px[c] - sel[c];
        d = d + metric_weight(true, c) * diff * diff;
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float diff = px[c] - bcx::i2f(lerp64(d0[c], d1[c], wk));
        d = d + diff * diff;
      }
    }
    acc |= (u64)i << (4 * p);
    e = e + d;
    if (w) w[p] = (uint8_t)wk;
  });
  idx = acc;
  err = e;
}

// The uber machinery's selector variant v of `base` over the pixels of the
// mask only: v < 3 the +-1 perturbations of the extreme selectors, v >= 3 the
// selector-scaling extrapolations in (ly, hy) order; false for the identity
// (0, max_sel), which is not a variant.
template <bool FULL>
__device__ __forceinline__ bool sel_variant(u64 base, uint32_t mask, int v, int q, int max_sel,
                                            int mn, int mx, u64& out) {
  u64 acc = 0;
  if (v < 3) {
    for_pixels<FULL>(mask, [&](int p) {
      const int r = get4(base, p);
      const bool up = r == mn && r < max_sel;
      const bool dn = r == mx && r > 0;
      const int o = v == 0 ? (up ? r + 1 : r) : (v == 1 ? (dn ? r - 1 : r) : (up ? r + 1 : (dn ? r - 1 : r)));
      acc |= (u64)o << (4 * p);
    });
    out = acc;
    return true;
  }
  const int span = q + 2;
  const int ly = -q + (v - 3) / span;
  const int hy = max_sel - 1 + (v - 3) % span;
  if (ly == 0 && hy == max_sel) return false;
  const float fms = (float)max_sel, fly = (float)ly, fden = (float)(hy - ly);
  for_pixels<FULL>(mask, [&](int p) {
    const float r = bcx::i2f(get4(base, p));
    const float s = floorf(fms * (r - fly) / fden + 0.5f);
    acc |= (u64)(int)fminf(fmaxf(s, 0.0f), fms) << (4 * p);
  });
  out = acc;
  return true;
}

#ifdef __CUDACC__
// The phase runner of group `grp` of L lanes (L divides 32, so a group lies
// inside one warp): run(f) runs the phase f on the calling lane, then the
// group's barrier, __syncwarp over the group's lanes (a lane alone has
// nothing to wait for). Control flow between phases depends only on launch
// arguments and on shared values read after a barrier, so every lane of a
// group reaches the same barriers; a group whose block lies past the end
// returns before its first phase, all its lanes together.
template <int L>
struct GroupRun {
  static_assert(32 % L == 0, "a group lies inside one warp");
  int lane;
  unsigned mask;
  __device__ __forceinline__ GroupRun(int grp, int lane_)
      : lane(lane_), mask((unsigned)((1ull << L) - 1u) << (L * (grp % (32 / L)))) {}
  template <class F>
  __device__ __forceinline__ void operator()(F&& f) const {
    f(lane);
    if constexpr (L > 1) __syncwarp(mask);
  }
};
#endif  // __CUDACC__

}  // namespace bc7
