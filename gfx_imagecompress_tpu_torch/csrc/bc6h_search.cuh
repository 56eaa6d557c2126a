// BC6H search (K6): the search of kernels/bc6h.py (and of the JAX package's
// bc6h_pallas.py _bc6h_kernel, body :475-584, launched at :635), signed and
// unsigned, all 14 modes.
//
// What bounds it: operations. A block is 192 bytes of half-ints in and 20
// bytes out against about 10^5 operations at the top tier: the estimate of 32
// two-region shapes, per kept shape two masked PCA + least-squares fits and
// per precision group two exact decode palettes, the one-region fit and race,
// and a shake of each race's winner (8 steps per channel, each an exact
// decode of its region).
//
// What the design does about it: a group of LANES lanes encodes one block; a
// CTA holds several groups. The group loads the 48 half-ints once into shared
// memory, as floats (exact: every half-int is below 2^17) and beside them in
// the work domain (one multiply each, the plain version's value), so no pass
// converts an integer: compute capability 9.0 converts int32 to float32 at
// an eighth of its float32 add rate, and the one-thread design converted
// some 12,000 times per block. The search is a sequence of phases,
// each dealing independent items to the lanes:
//   a. the 32 shapes' estimates, and the one-region fit;
//   b. the top-k pick on lane 0 (repeated argmin with removal, as the plain
//      version; the ids in rank order);
//   c. per chunk of KC kept shapes: both regions' fits of each (and, in the
//      first chunk, the enabled one-region modes' candidates); one item per
//      (shape, precision group): quantise, both regions' palettes, the swaps;
//      then on lane 0 the scan in the plain version's order (shape-major, the
//      modes of a group gated on its candidate), beside it the one-region
//      scan;
//   d. the shake of both races' winners at once: per round and channel one
//      item per (region, step), the start first; one scan per region; after
//      the three channels one item per region, its palette on the shaken
//      codes; then each winner re-swapped, re-gated and kept where better;
//   e. the solid-mean fallback, the final race and the pack on lane 0.
// A lane computes its item whole with the plain version's arithmetic and
// writes (error, state) to a slot; after the group's barrier the winners are
// picked by scans of the slots in the sequential order with the sequential
// loops' compares (strict <, the earlier candidate keeps a tie). No sum is
// reordered and no error goes through a shuffle tree.
// Why the items are independent: the estimates, fits and candidates read only
// the block and the fits; the one-region race does not depend on the
// two-region one (only the final race joins them); in the shake a channel's
// steps read the channel's codes at the round's fixed indices, channel c + 1
// sees channel c's codes (the channels stay in order), and a region's steps
// and palette read and write only that region's codes and index fields, kept
// apart per region (Region) and joined after the last round.
// The pixel passes of the palettes, the shake and the estimates visit the set
// bits of the region's mask, in ascending order; the fits keep the plain
// version's 16-pixel masked sums. Only the winner is packed, from the layouts
// of bc6h_layouts.cuh. The two sign conventions are two instantiations of one
// template.
//
// The route is CUDA C++: integer bit-fields, data-dependent loops and
// per-lane branching. Tensor cores (wgmma) and TMA are not used: the arithmetic
// is scalar float32 with a fixed order of summation, which no matrix unit
// keeps, and a block reads only 192 bytes.
//
// Bit-agreement with the plain version: candidates in its order (shape-major,
// then the precision groups in mode order, then the modes of a group; strict
// <, the first wins), float sums over pixels left to right in pixel order
// (a region's sum skips the other region's pixels, whose terms are +0 in the
// plain version), Python-double constants rounded once to float, rintf for
// half-to-even, IEEE division and square root, no multiply-add contraction
// (build flag).
#pragma once
#include "bc7_group.cuh"
#include "bc6h_layouts.cuh"

namespace bc6h {

typedef unsigned long long u64;

constexpr float BIG = 3.4e38f;
constexpr float EPS = (float)1e-8;

__device__ __forceinline__ int get4(u64 v, int p) { return (int)((v >> (4 * p)) & 15ull); }
__device__ __forceinline__ void set4(u64& v, int p, int x) {
  v = (v & ~(15ull << (4 * p))) | ((u64)x << (4 * p));
}

template <int IB>
__device__ __forceinline__ int weight(int i) {
  return IB == 4 ? bc7::weight4(i) : bc7::weight3(i);
}

// half-int -> work-domain float (the inverse of the decoder's finish scale)
template <bool SG>
__device__ __forceinline__ float work(int h) {
  return (float)h * (float)((SG ? 32.0 : 64.0) / 31.0);
}

// ---- integer decode path

template <bool SG>
__device__ __forceinline__ int quantize(float u, int prec) {
  if (!SG) {
    const int uq = (int)fminf(fmaxf(rintf(u), 0.0f), 65535.0f);
    const int mx = (1 << prec) - 1;
    if (prec >= 15) return bcx::clamp_i(uq, 0, mx);
    return bcx::clamp_i((uq * (1 << prec) + 0x8000) >> 16, 0, mx);
  }
  const int uq = (int)fminf(fmaxf(rintf(u), -32767.0f), 32767.0f);
  if (prec >= 16) return uq;
  const int mx = (1 << (prec - 1)) - 1;
  const int mag = uq < 0 ? -uq : uq;
  const int q = bcx::clamp_i((mag * (1 << (prec - 1)) + 0x4000) >> 15, 0, mx);
  return uq < 0 ? -q : q;
}

template <bool SG>
__device__ __forceinline__ int unquantize(int q, int prec) {
  if (!SG) {
    if (prec >= 15) return q;
    if (q == 0) return 0;
    if (q == (1 << prec) - 1) return 0xFFFF;
    return ((q << 16) + 0x8000) >> prec;
  }
  if (prec >= 16) return q;
  const int a = q < 0 ? -q : q;
  int u = ((a << 15) + 0x4000) >> (prec - 1);
  if (a == 0) u = 0;
  if (a >= (1 << (prec - 1)) - 1) u = 0x7FFF;
  return q < 0 ? -u : u;
}

// interpolated value -> the decoded integer the error is measured on
template <bool SG>
__device__ __forceinline__ int finish(int v) {
  if (!SG) return (v * 31) >> 6;
  const int mag = ((v < 0 ? -v : v) * 31) >> 5;
  return v < 0 ? -mag : mag;
}

template <bool SG>
__device__ __forceinline__ float decoded(int u0, int u1, int w) {
  return bcx::i2f(finish<SG>((u0 * (64 - w) + u1 * w + 32) >> 6));
}

// Exact palette of the pixels of `pmask`: each pixel's index of least
// squared distance (the first of equal ones) is written into `idx`; returns
// the sum of those distances in pixel order (the set bits of the mask,
// ascending: the plain version's masked sum less its +0 terms).
template <bool SG, int IB>
__device__ __forceinline__ float palette_err(const float (&h)[3][16], const int (&u0)[3],
                                             const int (&u1)[3], uint32_t pmask, u64& idx) {
  constexpr int NE = 1 << IB;
  float dec[NE][3];
#pragma unroll
  for (int k = 0; k < NE; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) dec[k][c] = decoded<SG>(u0[c], u1[c], weight<IB>(k));
  float err = 0.0f;
  for (uint32_t m = pmask; m; m &= m - 1) {
    const int p = __ffs(m) - 1;
    const float x0 = h[0][p], x1 = h[1][p], x2 = h[2][p];
    float best = 0.0f;
    int bi = 0;
#pragma unroll
    for (int k = 0; k < NE; ++k) {
      const float d0 = x0 - dec[k][0], d1 = x1 - dec[k][1], d2 = x2 - dec[k][2];
      float d = d0 * d0;
      d = d + d1 * d1;
      d = d + d2 * d2;
      if (k == 0 || d < best) {
        best = d;
        bi = k;
      }
    }
    err = err + best;
    set4(idx, p, bi);
  }
  return err;
}

// ---- estimate of a two-region shape: per region, the pixels centred on
// their mean, projected on the diagonal of their bounding box, quantised to
// 8 levels; squared distance to the axis plus squared quantisation error
__device__ float estimate_shape(const float (&hw)[3][16], uint32_t bits) {
  float est = 0.0f;
  bool first_term = true;
#pragma unroll 1
  for (int s = 0; s < 2; ++s) {
    const uint32_t rm = s ? (bits & 0xFFFFu) : (~bits & 0xFFFFu);
    float sum[3] = {0.0f, 0.0f, 0.0f};
    int cnt = 0;
    for (uint32_t m = rm; m; m &= m - 1) {
      const int p = __ffs(m) - 1;
#pragma unroll
      for (int c = 0; c < 3; ++c) sum[c] = cnt ? sum[c] + hw[c][p] : hw[c][p];
      ++cnt;
    }
    float mean[3], lo[3], hi[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      mean[c] = sum[c] / (float)cnt;
      lo[c] = BIG;
      hi[c] = -BIG;
    }
    bool first = true;
    for (uint32_t m = rm; m; m &= m - 1) {
      const int p = __ffs(m) - 1;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = hw[c][p] - mean[c];
        lo[c] = first ? v : fminf(lo[c], v);
        hi[c] = first ? v : fmaxf(hi[c], v);
      }
      first = false;
    }
    float axis[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) axis[c] = hi[c] - lo[c];
    float n2 = axis[0] * axis[0];
    n2 = n2 + axis[1] * axis[1];
    n2 = n2 + axis[2] * axis[2];
    const float inv = 1.0f / fmaxf(sqrtf(n2), (float)1e-6);
#pragma unroll
    for (int c = 0; c < 3; ++c) axis[c] = axis[c] * inv;
    float tmin = 0.0f, tmax = 0.0f;
    first = true;
    for (uint32_t m = rm; m; m &= m - 1) {
      const int p = __ffs(m) - 1;
      float t = (hw[0][p] - mean[0]) * axis[0];
      t = t + (hw[1][p] - mean[1]) * axis[1];
      t = t + (hw[2][p] - mean[2]) * axis[2];
      tmin = first ? t : fminf(tmin, t);
      tmax = first ? t : fmaxf(tmax, t);
      first = false;
    }
    const float span = fmaxf(tmax - tmin, (float)1e-6);
    for (uint32_t m = rm; m; m &= m - 1) {
      const int p = __ffs(m) - 1;
      const float c0 = hw[0][p] - mean[0];
      const float c1 = hw[1][p] - mean[1];
      const float c2 = hw[2][p] - mean[2];
      float t = c0 * axis[0];
      t = t + c1 * axis[1];
      t = t + c2 * axis[2];
      const float tq = rintf((t - tmin) / span * 7.0f);
      const float tr = tq * (float)(1.0 / 7.0) * span + tmin;
      float d2 = c0 * c0;
      d2 = d2 + c1 * c1;
      d2 = d2 + c2 * c2;
      d2 = d2 - t * t;
      const float add = d2 + (t - tr) * (t - tr);
      est = first_term ? add : est + add;
      first_term = false;
    }
  }
  return est;
}

// ---- masked PCA + least-squares fit in the work domain (IB: the palette's
// index bits, whose levels the least-squares rounds assign). The sums run
// over all 16 pixels, a pixel outside the mask weighted 0, as the plain
// version's; the pixel loops are kept rolled (a pixel's weight is made from
// the mask where it is used), the level loops unrolled.
template <int IB>
__device__ void fit_masked(const float (&hw)[3][16], uint32_t mbits, int iters, float (&e0)[3],
                           float (&e1)[3]) {
  auto mw = [&](int p) { return ((mbits >> p) & 1u) ? 1.0f : 0.0f; };
  float cnt = mw(0);
#pragma unroll 1
  for (int p = 1; p < 16; ++p) cnt = cnt + mw(p);
  cnt = fmaxf(cnt, 1.0f);
  float mean[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = hw[c][0] * mw(0);
#pragma unroll 1
    for (int p = 1; p < 16; ++p) s = s + hw[c][p] * mw(p);
    mean[c] = s / cnt;
  }
  float cov[6];  // 00 01 02 11 12 22
  {
    int k = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = a; b < 3; ++b) {
        float s = 0.0f;
#pragma unroll 1
        for (int p = 0; p < 16; ++p) {
          const float ca = (hw[a][p] - mean[a]) * mw(p);
          const float cb = (hw[b][p] - mean[b]) * mw(p);
          s = p ? s + ca * cb : ca * cb;
        }
        cov[k++] = s;
      }
  }
  const float c00 = cov[0], c01 = cov[1], c02 = cov[2], c11 = cov[3], c12 = cov[4], c22 = cov[5];
  float v0 = 1.0f, v1 = 1.0f, v2 = 1.0f;
#pragma unroll 1
  for (int r = 0; r < 8; ++r) {
    float n0 = c00 * v0;
    n0 = n0 + c01 * v1;
    n0 = n0 + c02 * v2;
    float n1 = c01 * v0;
    n1 = n1 + c11 * v1;
    n1 = n1 + c12 * v2;
    float n2 = c02 * v0;
    n2 = n2 + c12 * v1;
    n2 = n2 + c22 * v2;
    float nn = n0 * n0;
    nn = nn + n1 * n1;
    nn = nn + n2 * n2;
    const float n = sqrtf(nn);
    const bool ok = n > EPS;
    const float inv = 1.0f / fmaxf(n, EPS);
    if (ok) {
      v0 = n0 * inv;
      v1 = n1 * inv;
      v2 = n2 * inv;
    }
  }
  float axis[3];
  {
    float nn = v0 * v0;
    nn = nn + v1 * v1;
    nn = nn + v2 * v2;
    const float n = sqrtf(nn);
    const bool ok = n > EPS;
    const float inv = 1.0f / fmaxf(n, EPS);
    const float fb = (float)0.57735026;
    axis[0] = ok ? v0 * inv : fb;
    axis[1] = ok ? v1 * inv : fb;
    axis[2] = ok ? v2 * inv : fb;
  }
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll 1
  for (int p = 0; p < 16; ++p) {
    const float m = mw(p);
    float t = ((hw[0][p] - mean[0]) * m) * axis[0];
    t = t + ((hw[1][p] - mean[1]) * m) * axis[1];
    t = t + ((hw[2][p] - mean[2]) * m) * axis[2];
    const float lo = m > 0.0f ? t : (float)1e30;
    const float hi = m > 0.0f ? t : -(float)1e30;
    tmin = p ? fminf(tmin, lo) : lo;
    tmax = p ? fmaxf(tmax, hi) : hi;
  }
  if (tmin > tmax) tmin = 0.0f;
  if (tmax < tmin) tmax = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e0[c] = mean[c] + tmin * axis[c];
    e1[c] = mean[c] + tmax * axis[c];
  }
  constexpr int NL = 1 << IB;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float pal[NL][3];
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      const float l = bcx::i2f(weight<IB>(k)) * (1.0f / 64.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c) pal[k][c] = e0[c] + l * (e1[c] - e0[c]);
    }
    float q00 = 0.0f, q01 = 0.0f, q11 = 0.0f;
    float b0[3] = {0.0f, 0.0f, 0.0f}, b1[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int p = 0; p < 16; ++p) {
      const float x0 = hw[0][p], x1 = hw[1][p], x2 = hw[2][p];
      float bestd = 0.0f;
      int bk = 0;
#pragma unroll
      for (int k = 0; k < NL; ++k) {
        const float d0 = x0 - pal[k][0], d1 = x1 - pal[k][1], d2 = x2 - pal[k][2];
        float d = d0 * d0;
        d = d + d1 * d1;
        d = d + d2 * d2;
        if (k == 0 || d < bestd) {
          bestd = d;
          bk = k;
        }
      }
      const float m = mw(p);
      const float alpha = bcx::i2f(weight<IB>(bk)) * (1.0f / 64.0f);
      const float one_a = (1.0f - alpha) * m;
      const float a_m = alpha * m;
      const float t00 = one_a * (1.0f - alpha), t01 = one_a * alpha, t11 = a_m * alpha;
      q00 = p ? q00 + t00 : t00;
      q01 = p ? q01 + t01 : t01;
      q11 = p ? q11 + t11 : t11;
      const float xs[3] = {x0, x1, x2};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        b0[c] = p ? b0[c] + one_a * xs[c] : one_a * xs[c];
        b1[c] = p ? b1[c] + a_m * xs[c] : a_m * xs[c];
      }
    }
    const float det = q00 * q11 - q01 * q01;
    const bool okd = fabsf(det) > (float)1e-6;
    const float invd = 1.0f / (okd ? det : 1.0f);
    if (okd) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        e0[c] = (q11 * b0[c] - q01 * b1[c]) * invd;
        e1[c] = (q00 * b1[c] - q01 * b0[c]) * invd;
      }
    }
  }
}

// ---- candidates

struct Cand {
  float err;
  int mi;     // mode index 0..13
  int shape;  // two-region shape 0..31 (0 for one region)
  int q[4][3];  // swapped endpoints w, x, y, z (one region: x, y repeat w, x)
  u64 idx;
};

__device__ __forceinline__ bool delta_fits(int d, int bits) {
  return d >= -(1 << (bits - 1)) && d <= (1 << (bits - 1)) - 1;
}

// the delta-fit gate of a transformed mode on swapped endpoints
__device__ __forceinline__ float gate(int mi, const int (&q)[4][3], float err, int regions) {
  const ModeInfo& m = MODES[mi];
  if (!m.transformed) return err;
  bool ok = true;
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (regions == 1 && j > 1) break;
#pragma unroll
    for (int c = 0; c < 3; ++c) ok = ok && delta_fits(q[j][c] - q[0][c], m.delta_bits[c]);
  }
  return ok ? err : BIG;
}

// anchor swaps of a two-region candidate: pixel 0 anchors region 0, `anchor`
// region 1; where an anchor's index has its MSB set the region's indices are
// complemented and its endpoints swapped
__device__ __forceinline__ void swap2(u64& idx, uint32_t in1, int anchor, int (&q)[4][3]) {
  if (get4(idx, 0) & 4) {
#pragma unroll
    for (int p = 0; p < 16; ++p)
      if (!((in1 >> p) & 1u)) set4(idx, p, 7 - get4(idx, p));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int t = q[0][c];
      q[0][c] = q[1][c];
      q[1][c] = t;
    }
  }
  if (get4(idx, anchor) & 4) {
#pragma unroll
    for (int p = 0; p < 16; ++p)
      if ((in1 >> p) & 1u) set4(idx, p, 7 - get4(idx, p));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int t = q[2][c];
      q[2][c] = q[3][c];
      q[3][c] = t;
    }
  }
}

// anchor swap of a one-region candidate: q[0], q[1] swapped, then copied
// into q[2], q[3]
__device__ __forceinline__ void swap1(u64& idx, int (&q)[4][3]) {
  if (get4(idx, 0) & 8) {
    idx = 0xFFFFFFFFFFFFFFFFull - idx;  // 15 - i in every field
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int t = q[0][c];
      q[0][c] = q[1][c];
      q[1][c] = t;
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q[2][c] = q[0][c];
    q[3][c] = q[1][c];
  }
}

// ---- the shake's channel error of one region: the channel's two codes (a,
// b) at the region's fixed indices, squared distance summed over the
// region's pixels in ascending order
template <bool SG, int IB>
__device__ __forceinline__ float ch_err(const float (&hc)[16], int a, int b, int prec, uint32_t pmask,
                                        u64 idx) {
  const int u0 = unquantize<SG>(a, prec), u1 = unquantize<SG>(b, prec);
  float acc = 0.0f;
  for (uint32_t m = pmask; m; m &= m - 1) {
    const int p = __ffs(m) - 1;
    const float diff = hc[p] - decoded<SG>(u0, u1, weight<IB>(get4(idx, p)));
    acc = acc + diff * diff;
  }
  return acc;
}

// ---- launch shape: L lanes per block; KC kept shapes per chunk of the
// two-region phases (2 * KC fits, 6 * KC race candidates). Measured on the
// H100 at 2, 4, 8 and 16 lanes (PERF.md): on a 1K image 4 and 2 alike at
// the top tier, 4 the fastest at quality 0.8 and 0.3 and on small images.
template <int L>
struct Shape {
  enum {
    LANES = L,
    THREADS = L >= 8 ? 128 : 64,  // threads per CTA
    BLOCKS = THREADS / L,         // BC6H blocks per CTA
    MIN_CTAS = 512 / THREADS,     // CTAs per SM: at most 128 registers
    KC = L >= 8 ? 4 : (L >= 4 ? 2 : 1),
  };
};

// the lanes per block of bc6h_encode (kernels/bc6h.py BC6H_LANES)
constexpr int LANES = 4;

// a race candidate in a slot: error (a precision group's ungated sum, or a
// one-region mode's gated error), swapped codes (16 bits each: the signed
// ones as int16), indices
struct Slot {
  float err;
  uint16_t q[4][3];
  u64 idx;
};

template <bool SG>
__device__ __forceinline__ int slot_q(const Slot& s, int j, int c) {
  return SG ? (int)(int16_t)s.q[j][c] : (int)s.q[j][c];
}

// one region of a race winner under the shake: its codes, indices (its own
// fields only), pixels and its error after the last round
struct Region {
  int qa[3], qb[3];
  u64 idx;
  uint32_t pmask;
  float err;
};

// The group's shared struct. Each union's members live in disjoint spans of
// phases: the estimates until the pick, the one-region candidates until
// their scan, the shake's errors after it; the race candidates until the last
// scan, the shaken regions after it.
template <int L>
struct Shared {
  float h[3][16];         // the block's half-ints, channel-major, as floats (exact)
  float hw[3][16];        // and in the work domain (work<SG>)
  float f1[2][3];         // the one-region fit
  float fit[Shape<L>::KC][4][3];  // a chunk's two-region fits, per kept shape
  uint8_t ids[32];        // the kept shapes in rank order
  int have2, have1;       // a two-region / one-region candidate was taken
  Cand best2, best1;      // the races' winners
  union {
    float ests[32];       // the 32 shapes' estimates
    Slot one[4];          // the one-region modes' candidates
    float se[3][9];       // a shake channel's errors: per region, the start and 8 steps
  } u;
  union {
    Slot slot[6 * Shape<L>::KC];  // a chunk's (kept shape, precision group) candidates
    Region rg[3];         // under the shake: the two-region winner's regions, the one-region's
  } v;
};

// the enabled two-region modes grouped by precision, in mode order: a new
// group where the precision changes (the plain version's order)
struct Groups {
  int n, prec[10];
};

__device__ __forceinline__ Groups groups_of(int mode_mask) {
  Groups g;
  g.n = 0;
  int cur = -1;
#pragma unroll 1
  for (int mi = 0; mi < 10; ++mi) {
    if (!((mode_mask >> mi) & 1)) continue;
    if (MODES[mi].base_bits != cur) {
      cur = MODES[mi].base_bits;
      g.prec[g.n++] = cur;
    }
  }
  return g;
}

// the j-th enabled one-region mode
__device__ __forceinline__ int one_mode(int mode_mask, int j) {
#pragma unroll 1
  for (int mi = 10; mi < 14; ++mi)
    if ((mode_mask >> mi) & 1) {
      if (j == 0) return mi;
      --j;
    }
  return -1;
}

// ---- the items

// race candidate of kept shape `sid` at precision `prec`: both regions'
// exact palettes and the anchor swaps
template <bool SG, int L>
__device__ __forceinline__ void race_item(const Shared<L>& sh, int kk, int sid, int prec, Slot& out) {
  const uint32_t in1 = bc7::P2[sid];
  int q[4][3], u[4][3];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q[j][c] = quantize<SG>(sh.fit[kk][j][c], prec);
      u[j][c] = unquantize<SG>(q[j][c], prec);
    }
  u64 idx = 0;
  const float err0 = palette_err<SG, 3>(sh.h, u[0], u[1], ~in1 & 0xFFFFu, idx);
  const float err1 = palette_err<SG, 3>(sh.h, u[2], u[3], in1, idx);
  swap2(idx, in1, bc7::ANCHOR2[sid], q);
  out.err = err0 + err1;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c) out.q[j][c] = (uint16_t)q[j][c];
  out.idx = idx;
}

// one-region candidate of mode mi: its exact palette, the anchor swap and
// the gate
template <bool SG, int L>
__device__ __forceinline__ void one_item(const Shared<L>& sh, int mi, Slot& out) {
  const int prec = MODES[mi].base_bits;
  int q[4][3], u0[3], u1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q[0][c] = quantize<SG>(sh.f1[0][c], prec);
    q[1][c] = quantize<SG>(sh.f1[1][c], prec);
    u0[c] = unquantize<SG>(q[0][c], prec);
    u1[c] = unquantize<SG>(q[1][c], prec);
  }
  u64 idx = 0;
  const float err = palette_err<SG, 4>(sh.h, u0, u1, 0xFFFFu, idx);
  swap1(idx, q);
  out.err = gate(mi, q, err, 1);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c) out.q[j][c] = (uint16_t)q[j][c];
  out.idx = idx;
}

template <bool SG>
__device__ __forceinline__ void cand_of(const Slot& s, int mi, int shape, float err, Cand& c) {
  c.err = err;
  c.mi = mi;
  c.shape = shape;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c2 = 0; c2 < 3; ++c2) c.q[j][c2] = slot_q<SG>(s, j, c2);
  c.idx = s.idx;
}

// The two-region scan over a chunk's kept shapes k0.., in the plain
// version's order: shape-major, then the enabled modes in mode order, each
// gated on its precision group's candidate; strict <, the first candidate of
// the search taken as is.
template <bool SG, int L>
__device__ __forceinline__ void scan2(Shared<L>& sh, int mode_mask, const Groups& gr, int k0, int nk) {
#pragma unroll 1
  for (int kk = 0; kk < nk; ++kk) {
    int cur = -1, g = -1;
#pragma unroll 1
    for (int mi = 0; mi < 10; ++mi) {
      if (!((mode_mask >> mi) & 1)) continue;
      if (MODES[mi].base_bits != cur) {
        cur = MODES[mi].base_bits;
        ++g;
      }
      const Slot& s = sh.v.slot[kk * gr.n + g];
      int q[4][3];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 3; ++c) q[j][c] = slot_q<SG>(s, j, c);
      const float em = gate(mi, q, s.err, 2);
      if (!sh.have2 || em < sh.best2.err) {
        cand_of<SG>(s, mi, sh.ids[k0 + kk], em, sh.best2);
        sh.have2 = 1;
      }
    }
  }
}

// the one-region scan over the enabled modes in order, strict <
template <bool SG, int L>
__device__ __forceinline__ void scan1(Shared<L>& sh, int mode_mask, int n1) {
#pragma unroll 1
  for (int j = 0; j < n1; ++j) {
    const Slot& s = sh.u.one[j];
    if (!sh.have1 || s.err < sh.best1.err) {
      cand_of<SG>(s, one_mode(mode_mask, j), 0, s.err, sh.best1);
      sh.have1 = 1;
    }
  }
}

// the shake's start: region r's codes and its own index fields (r = 0, 1:
// the two-region winner's; r = 2: the one-region winner's)
template <int L>
__device__ __forceinline__ void shake_start(Shared<L>& sh, int r) {
  Region& g = sh.v.rg[r];
  const Cand& c = r == 2 ? sh.best1 : sh.best2;
  const uint32_t in1 = bc7::P2[c.shape];
  g.pmask = r == 2 ? 0xFFFFu : (r ? (in1 & 0xFFFFu) : (~in1 & 0xFFFFu));
  const int j0 = r == 1 ? 2 : 0;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    g.qa[ch] = c.q[j0][ch];
    g.qb[ch] = c.q[j0 + 1][ch];
  }
  g.idx = r == 2 ? c.idx : (c.idx & bc7::nibble_mask(g.pmask));
}

// shake step j of a channel's codes: j = 0 the start (unclamped), j = 1..8
// the steps (+-1, +-1) in order, the (0, 0) step left out, clamped to the
// precision's range
template <bool SG>
__device__ __forceinline__ void shake_codes(const Region& g, int c, int j, int prec, int& a, int& b) {
  if (j == 0) {
    a = g.qa[c];
    b = g.qb[c];
    return;
  }
  const int qlo = SG ? -((1 << (prec - 1)) - 1) : 0;
  const int qhi = SG ? (1 << (prec - 1)) - 1 : (1 << prec) - 1;
  const int s = j - 1 + (j >= 5 ? 1 : 0);
  a = min(max(g.qa[c] + s / 3 - 1, qlo), qhi);
  b = min(max(g.qb[c] + s % 3 - 1, qlo), qhi);
}

// the region's palette on its shaken codes, requantising its indices
template <bool SG, int IB, int L>
__device__ __forceinline__ void shake_palette(Shared<L>& sh, int r, int prec) {
  Region& g = sh.v.rg[r];
  int u0[3], u1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    u0[c] = unquantize<SG>(g.qa[c], prec);
    u1[c] = unquantize<SG>(g.qb[c], prec);
  }
  g.err = palette_err<SG, IB>(sh.h, u0, u1, g.pmask, g.idx);
}

// A race winner after its shake: re-swapped, re-gated, kept where strictly
// better.
template <bool SG, int L>
__device__ __forceinline__ void shake_end(Shared<L>& sh, int regions) {
  Cand& best = regions == 2 ? sh.best2 : sh.best1;
  Cand c = best;
  float err;
  if (regions == 2) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      c.q[0][ch] = sh.v.rg[0].qa[ch];
      c.q[1][ch] = sh.v.rg[0].qb[ch];
      c.q[2][ch] = sh.v.rg[1].qa[ch];
      c.q[3][ch] = sh.v.rg[1].qb[ch];
    }
    c.idx = sh.v.rg[0].idx | sh.v.rg[1].idx;
    err = sh.v.rg[0].err + sh.v.rg[1].err;
    swap2(c.idx, bc7::P2[c.shape], bc7::ANCHOR2[c.shape], c.q);
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      c.q[0][ch] = sh.v.rg[2].qa[ch];
      c.q[1][ch] = sh.v.rg[2].qb[ch];
    }
    c.idx = sh.v.rg[2].idx;
    err = sh.v.rg[2].err;
    swap1(c.idx, c.q);
  }
  c.err = gate(best.mi, c.q, err, regions);
  if (c.err < best.err) best = c;
}

// ---- the solid-mean fallback and the pack, on one lane
template <bool SG, int L>
__device__ __forceinline__ void finish_block(const Shared<L>& sh, int fb, uint32_t (&words)[4],
                                             float& err_out) {
  const bool has2 = sh.have2 != 0, has1 = sh.have1 != 0;
  Cand best = has2 ? sh.best2 : sh.best1;
  if (has2 && has1 && sh.best1.err < sh.best2.err) best = sh.best1;

  if (fb >= 0) {
    // every enabled mode is transformed: a solid-mean candidate fits any
    const int prec = MODES[fb].base_bits;
    Cand cand;
    int u[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s = sh.hw[c][0];
#pragma unroll 1
      for (int p = 1; p < 16; ++p) s = s + sh.hw[c][p];
      const int qm = quantize<SG>(s / 16.0f, prec);
      u[c] = unquantize<SG>(qm, prec);
#pragma unroll
      for (int j = 0; j < 4; ++j) cand.q[j][c] = qm;
    }
    u64 unused = 0;
    cand.err = MODES[fb].regions == 1 ? palette_err<SG, 4>(sh.h, u, u, 0xFFFFu, unused)
                                      : palette_err<SG, 3>(sh.h, u, u, 0xFFFFu, unused);
    cand.mi = fb;
    cand.shape = 0;
    cand.idx = 0;
    if (cand.err < best.err) best = cand;
  }

  const ModeInfo& m = MODES[best.mi];
  int f[12];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f[c] = best.q[0][c] & ((1 << m.base_bits) - 1);
    const int dmask = (1 << m.delta_bits[c]) - 1;
#pragma unroll
    for (int j = 1; j < 4; ++j)
      f[3 * j + c] = (m.transformed ? best.q[j][c] - best.q[0][c] : best.q[j][c]) & dmask;
  }
  u64 lo = 0, hi = 0;
  auto put = [&](uint32_t v, int pos, int nbits) {
    const u64 val = (u64)(v & ((1u << nbits) - 1u));
    if (pos >= 64) {
      hi |= val << (pos - 64);
    } else {
      lo |= val << pos;
      if (pos + nbits > 64) hi |= val >> (64 - pos);
    }
  };
  put(m.code, 0, m.code_bits);
#pragma unroll 1
  for (int s = 0; s < m.nseg; ++s) {
    const uint8_t* g = SEGS[best.mi][s];
    put((uint32_t)(f[g[0]] >> g[1]), g[2], g[3]);
  }
  if (m.regions == 2) {
    put((uint32_t)best.shape, TWO_REGION_SHAPE_BIT, 5);
    const int anchor = bc7::ANCHOR2[best.shape];
    int pos = TWO_REGION_INDEX_BIT;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int nb = (p == 0 || p == anchor) ? 2 : 3;
      put((uint32_t)get4(best.idx, p), pos, nb);
      pos += nb;
    }
  } else {
    put((uint32_t)get4(best.idx, 0), ONE_REGION_INDEX_BIT, 3);
#pragma unroll
    for (int p = 1; p < 16; ++p) put((uint32_t)get4(best.idx, p), ONE_REGION_INDEX_BIT + 4 * p - 1, 4);
  }
  words[0] = (uint32_t)lo;
  words[1] = (uint32_t)(lo >> 32);
  words[2] = (uint32_t)hi;
  words[3] = (uint32_t)(hi >> 32);
  err_out = best.err;
}

// ---- the whole search of block i on the group's shared struct
template <bool SG, int L, class Run>
__device__ __forceinline__ void search_block(Shared<L>& sh, const int* __restrict__ hg, int64_t i,
                                             int topk, int iters, int shake, int mode_mask, int fb,
                                             uint32_t* __restrict__ words, float* __restrict__ err,
                                             Run&& run) {
  constexpr int KC = Shape<L>::KC;
  const bool has2 = (mode_mask & 0x3FF) != 0, has1 = (mode_mask & 0x3C00) != 0;
  const Groups gr = groups_of(mode_mask);
  const int n1 = __popc((unsigned)(mode_mask >> 10) & 15u);

  // the load: the 48 half-ints, the lanes side by side
  run([&](int lane) {
    const int* b = hg + i * 48;
#pragma unroll 1
    for (int t = lane; t < 48; t += L) {
      sh.h[t % 3][t / 3] = (float)b[t];
      sh.hw[t % 3][t / 3] = work<SG>(b[t]);
    }
    if (lane == 0) sh.have2 = sh.have1 = 0;
  });

  // the 32 shapes' estimates; the one-region fit last
  run([&](int lane) {
    const int ne = has2 ? 32 : 0;
#pragma unroll 1
    for (int t = lane; t < ne + (has1 ? 1 : 0); t += L) {
      if (t < ne)
        sh.u.ests[t] = estimate_shape(sh.hw, bc7::P2[t]);
      else
        fit_masked<4>(sh.hw, 0xFFFFu, iters, sh.f1[0], sh.f1[1]);
    }
  });

  // the top-k shapes: repeated argmin with removal, the lower shape first on
  // a tie, as the plain version picks them
  if (has2)
    run([&](int lane) {
      if (lane != 0) return;
#pragma unroll 1
      for (int r = 0; r < topk; ++r) {
        int sid = 0;
        float bst = sh.u.ests[0];
#pragma unroll 1
        for (int j = 1; j < 32; ++j)
          if (sh.u.ests[j] < bst) {
            bst = sh.u.ests[j];
            sid = j;
          }
        sh.u.ests[sid] = BIG;
        sh.ids[r] = (uint8_t)sid;
      }
    });

  // per chunk of KC kept shapes: both regions' fits (and, in the first
  // chunk, the one-region candidates), the (shape, precision group)
  // candidates, the scans in order
  const int nk2 = has2 ? topk : 0;
#pragma unroll 1
  for (int k0 = 0; k0 == 0 || k0 < nk2; k0 += KC) {
    const int nk = min(KC, nk2 - k0);
    const int nf = 2 * nk, n1k = k0 == 0 && has1 ? n1 : 0;
    run([&](int lane) {
#pragma unroll 1
      for (int t = lane; t < nf + n1k; t += L) {
        if (t < nf) {
          const uint32_t in1 = bc7::P2[sh.ids[k0 + t / 2]];
          const int kk = t / 2, r = t % 2;
          fit_masked<3>(sh.hw, r ? in1 : (~in1 & 0xFFFFu), iters, sh.fit[kk][2 * r],
                            sh.fit[kk][2 * r + 1]);
        } else {
          one_item<SG>(sh, one_mode(mode_mask, t - nf), sh.u.one[t - nf]);
        }
      }
    });
    if (nk > 0)
      run([&](int lane) {
#pragma unroll 1
        for (int t = lane; t < nk * gr.n; t += L)
          race_item<SG>(sh, t / gr.n, sh.ids[k0 + t / gr.n], gr.prec[t % gr.n], sh.v.slot[t]);
      });
    run([&](int lane) {
      if (lane == 0 && nk > 0) scan2<SG>(sh, mode_mask, gr, k0, nk);
      if (lane == (L > 1 ? 1 : 0) && n1k > 0) scan1<SG>(sh, mode_mask, n1);
    });
  }

  // the shake of each race's winner, both at once: per round, channel by
  // channel, every region's start and 8 steps side by side, then a scan per
  // region; after the three channels each region's palette on its codes
  if (shake) {
    const int r0 = has2 ? 0 : 2, r1 = has1 ? 3 : 2;  // the regions [r0, r1)
    const int prec2 = has2 ? MODES[sh.best2.mi].base_bits : 0;
    const int prec1 = has1 ? MODES[sh.best1.mi].base_bits : 0;
    run([&](int lane) {
#pragma unroll 1
      for (int r = r0 + lane; r < r1; r += L) shake_start(sh, r);
    });
    const int nitem = 9 * (r1 - r0);
#pragma unroll 1
    for (int rd = 0; rd < shake; ++rd) {
#pragma unroll 1
      for (int c = 0; c < 3; ++c) {
        run([&](int lane) {
#pragma unroll 1
          for (int t = lane; t < nitem; t += L) {
            const int r = r0 + t / 9, j = t % 9;
            const Region& g = sh.v.rg[r];
            const int prec = r == 2 ? prec1 : prec2;
            int a, b;
            shake_codes<SG>(g, c, j, prec, a, b);
            sh.u.se[r][j] = r == 2 ? ch_err<SG, 4>(sh.h[c], a, b, prec, g.pmask, g.idx)
                                   : ch_err<SG, 3>(sh.h[c], a, b, prec, g.pmask, g.idx);
          }
        });
        run([&](int lane) {
#pragma unroll 1
          for (int r = r0 + lane; r < r1; r += L) {
            Region& g = sh.v.rg[r];
            float be = sh.u.se[r][0];
            const int j = 1 + bc7::scan_min(be, 8, [&](int t) { return sh.u.se[r][1 + t]; });
            int a, b;
            shake_codes<SG>(g, c, j, r == 2 ? prec1 : prec2, a, b);
            g.qa[c] = a;
            g.qb[c] = b;
          }
        });
      }
      run([&](int lane) {
#pragma unroll 1
        for (int r = r0 + lane; r < r1; r += L) {
          if (r == 2)
            shake_palette<SG, 4>(sh, 2, prec1);
          else
            shake_palette<SG, 3>(sh, r, prec2);
        }
      });
    }
    run([&](int lane) {
      if (lane == 0 && has2) shake_end<SG>(sh, 2);
      if (lane == (L > 1 ? 1 : 0) && has1) shake_end<SG>(sh, 1);
    });
  }

  run([&](int lane) {
    if (lane != 0) return;
    uint32_t w[4];
    float e;
    finish_block<SG>(sh, fb, w, e);
#pragma unroll
    for (int k = 0; k < 4; ++k) words[4 * i + k] = w[k];
    err[i] = e;
  });
}

#ifdef __CUDACC__
// The kernel and its launcher; the host build of this header for the tests
// stops before them. Group `grp` of the CTA encodes block
// blockIdx.x * BLOCKS + grp; its phases run through bc7::GroupRun.
template <bool SG, int L>
__global__ void __launch_bounds__(Shape<L>::THREADS, Shape<L>::MIN_CTAS)
bc6h_kernel(const int* __restrict__ h, int64_t n, int topk, int iters, int shake, int mode_mask,
            int fb, uint32_t* __restrict__ words, float* __restrict__ err) {
  constexpr int B = Shape<L>::BLOCKS;
  __shared__ Shared<L> sh[B];
  const int grp = threadIdx.x / L;
  const int64_t i = (int64_t)blockIdx.x * B + grp;
  if (i >= n) return;
  search_block<SG, L>(sh[grp], h, i, topk, iters, shake, mode_mask, fb, words, err,
                      bc7::GroupRun<L>(grp, threadIdx.x % L));
}

// Launches the kernel with L lanes per block on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel does
// not take. `fb` is the mode index of the solid-mean fallback, or -1 (the host
// decides it from the mask: kernels/bc6h.py fallback_mode).
template <int L>
inline int launch(const int* h, long long n, int sg, int topk, int iters, int shake,
                  int mode_mask, int fb, uint32_t* words, float* err, void* stream) {
  if (topk < 1 || topk > 32 || iters < 0 || shake < 0 || !(mode_mask & 0x3FFF) ||
      fb < -1 || fb >= NMODES || (fb >= 0 && !((mode_mask >> fb) & 1)))
    return (int)cudaErrorInvalidValue;
  constexpr int B = Shape<L>::BLOCKS, T = Shape<L>::THREADS;
  const unsigned grid = (unsigned)((n + B - 1) / B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sg)
    bc6h_kernel<true, L><<<grid, T, 0, s>>>(h, n, topk, iters, shake, mode_mask, fb, words, err);
  else
    bc6h_kernel<false, L><<<grid, T, 0, s>>>(h, n, topk, iters, shake, mode_mask, fb, words, err);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace bc6h
