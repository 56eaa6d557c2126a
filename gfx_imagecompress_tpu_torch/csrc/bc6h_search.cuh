// BC6H search (K6): the search of kernels/bc6h.py (and of the JAX package's
// bc6h_pallas.py _bc6h_kernel), signed and unsigned, all 14 modes.
//
// What bounds it: operations. A block is 192 bytes of half-ints in and 20
// bytes out against about 10^5 operations at the top tier: the estimate of 32
// two-region shapes, per kept shape two masked PCA + least-squares fits and
// per precision group two exact decode palettes over the 16 pixels, the
// one-region race, and a shake of each race's winner (8 steps per channel,
// each an exact decode of its region).
// What the design does about it: one thread per block; the 48 half-ints in
// registers as integers for the whole search, the work-domain floats made
// again where they are used (one multiply, the same value as the plain
// version's); a palette's decoded entries computed once per candidate and
// each pixel evaluated only against its own region's palette; the 16 indices
// of a candidate packed 4 bits each in one 64-bit word. Shapes are taken in
// rank order as they are raced, so no list of kept shapes is held. The two
// sign conventions are two instantiations of one template. Only the winner
// is packed, from the layouts of bc6h_layouts.cuh.
//
// Bit-agreement with the plain version: candidates in its order (shape-major,
// then the precision groups in mode order, then the modes of a group; strict
// <, the first wins), float sums over pixels left to right in pixel order
// (a region's sum skips the other region's pixels, whose terms are +0 in the
// plain version), Python-double constants rounded once to float, rintf for
// half-to-even, IEEE division and square root, no multiply-add contraction
// (build flag).
#pragma once
#include "bc7_common.cuh"
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
  return (float)finish<SG>((u0 * (64 - w) + u1 * w + 32) >> 6);
}

// Exact palette of the pixels of `pmask`: each pixel's index of least
// squared distance (the first of equal ones) is written into `idx`; returns
// the sum of those distances in pixel order.
template <bool SG, int IB>
__device__ __forceinline__ float palette_err(const int (&h)[3][16], const int (&u0)[3],
                                             const int (&u1)[3], uint32_t pmask, u64& idx) {
  constexpr int NE = 1 << IB;
  float dec[NE][3];
#pragma unroll
  for (int k = 0; k < NE; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) dec[k][c] = decoded<SG>(u0[c], u1[c], weight<IB>(k));
  float err = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    if (!((pmask >> p) & 1u)) continue;
    const float x0 = (float)h[0][p], x1 = (float)h[1][p], x2 = (float)h[2][p];
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
template <bool SG>
__device__ float estimate_shape(const int (&h)[3][16], uint32_t bits) {
  float est = 0.0f;
  bool first_term = true;
#pragma unroll 1
  for (int s = 0; s < 2; ++s) {
    float sum[3] = {0.0f, 0.0f, 0.0f};
    int cnt = 0;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      if ((int)((bits >> p) & 1u) != s) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) sum[c] = cnt ? sum[c] + work<SG>(h[c][p]) : work<SG>(h[c][p]);
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
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      if ((int)((bits >> p) & 1u) != s) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = work<SG>(h[c][p]) - mean[c];
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
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      if ((int)((bits >> p) & 1u) != s) continue;
      float t = (work<SG>(h[0][p]) - mean[0]) * axis[0];
      t = t + (work<SG>(h[1][p]) - mean[1]) * axis[1];
      t = t + (work<SG>(h[2][p]) - mean[2]) * axis[2];
      tmin = first ? t : fminf(tmin, t);
      tmax = first ? t : fmaxf(tmax, t);
      first = false;
    }
    const float span = fmaxf(tmax - tmin, (float)1e-6);
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      if ((int)((bits >> p) & 1u) != s) continue;
      const float c0 = work<SG>(h[0][p]) - mean[0];
      const float c1 = work<SG>(h[1][p]) - mean[1];
      const float c2 = work<SG>(h[2][p]) - mean[2];
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
// index bits, whose levels the least-squares rounds assign)
template <bool SG, int IB>
__device__ void fit_masked(const int (&h)[3][16], uint32_t mbits, int iters, float (&e0)[3],
                           float (&e1)[3]) {
  float m[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) m[p] = ((mbits >> p) & 1u) ? 1.0f : 0.0f;
  float cnt = m[0];
#pragma unroll
  for (int p = 1; p < 16; ++p) cnt = cnt + m[p];
  cnt = fmaxf(cnt, 1.0f);
  float mean[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = work<SG>(h[c][0]) * m[0];
#pragma unroll
    for (int p = 1; p < 16; ++p) s = s + work<SG>(h[c][p]) * m[p];
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
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          const float ca = (work<SG>(h[a][p]) - mean[a]) * m[p];
          const float cb = (work<SG>(h[b][p]) - mean[b]) * m[p];
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
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    float t = ((work<SG>(h[0][p]) - mean[0]) * m[p]) * axis[0];
    t = t + ((work<SG>(h[1][p]) - mean[1]) * m[p]) * axis[1];
    t = t + ((work<SG>(h[2][p]) - mean[2]) * m[p]) * axis[2];
    const float lo = m[p] > 0.0f ? t : (float)1e30;
    const float hi = m[p] > 0.0f ? t : -(float)1e30;
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
      const float l = (float)weight<IB>(k) * (1.0f / 64.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c) pal[k][c] = e0[c] + l * (e1[c] - e0[c]);
    }
    float q00 = 0.0f, q01 = 0.0f, q11 = 0.0f;
    float b0[3] = {0.0f, 0.0f, 0.0f}, b1[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const float x0 = work<SG>(h[0][p]), x1 = work<SG>(h[1][p]), x2 = work<SG>(h[2][p]);
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
      const float alpha = (float)weight<IB>(bk) * (1.0f / 64.0f);
      const float one_a = (1.0f - alpha) * m[p];
      const float a_m = alpha * m[p];
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

// ---- the shake of one region of the race winner (its precision `prec`):
// per round, channel by channel, greedily, the 8 steps (+-1, +-1) of the
// channel's two codes at fixed indices, clamped to [qlo, qhi]; then the
// region's indices requantised. Returns the last round's region error.
template <bool SG, int IB>
__device__ __forceinline__ float ch_err(const int (&hc)[16], int a, int b, int prec, uint32_t pmask,
                                        u64 idx) {
  const int u0 = unquantize<SG>(a, prec), u1 = unquantize<SG>(b, prec);
  float acc = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    if (!((pmask >> p) & 1u)) continue;
    const float diff = (float)hc[p] - decoded<SG>(u0, u1, weight<IB>(get4(idx, p)));
    acc = acc + diff * diff;
  }
  return acc;
}

template <bool SG, int IB>
__device__ float shake_region(const int (&h)[3][16], uint32_t pmask, int prec, int rounds,
                              int (&qa)[3], int (&qb)[3], u64& idx) {
  const int qlo = SG ? -((1 << (prec - 1)) - 1) : 0;
  const int qhi = SG ? (1 << (prec - 1)) - 1 : (1 << prec) - 1;
  float err = 0.0f;
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float best_e = ch_err<SG, IB>(h[c], qa[c], qb[c], prec, pmask, idx);
      int b0 = qa[c], b1 = qb[c];
#pragma unroll 1
      for (int s = 0; s < 9; ++s) {
        if (s == 4) continue;  // the (0, 0) step
        const int nq0 = min(max(qa[c] + s / 3 - 1, qlo), qhi);
        const int nq1 = min(max(qb[c] + s % 3 - 1, qlo), qhi);
        const float e = ch_err<SG, IB>(h[c], nq0, nq1, prec, pmask, idx);
        if (e < best_e) {
          best_e = e;
          b0 = nq0;
          b1 = nq1;
        }
      }
      qa[c] = b0;
      qb[c] = b1;
    }
    int u0[3], u1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u0[c] = unquantize<SG>(qa[c], prec);
      u1[c] = unquantize<SG>(qb[c], prec);
    }
    err = palette_err<SG, IB>(h, u0, u1, pmask, idx);
  }
  return err;
}

// shake the winner of a race, re-swap, re-gate, keep where strictly better
template <bool SG, int REGIONS>
__device__ void shake_best(const int (&h)[3][16], int rounds, Cand& best) {
  const int prec = MODES[best.mi].base_bits;
  Cand c = best;
  float err;
  if (REGIONS == 2) {
    const uint32_t in1 = bc7::P2[c.shape];
    const float e0 = shake_region<SG, 3>(h, ~in1 & 0xFFFFu, prec, rounds, c.q[0], c.q[1], c.idx);
    const float e1 = shake_region<SG, 3>(h, in1, prec, rounds, c.q[2], c.q[3], c.idx);
    err = e0 + e1;
    swap2(c.idx, in1, bc7::ANCHOR2[c.shape], c.q);
  } else {
    err = shake_region<SG, 4>(h, 0xFFFFu, prec, rounds, c.q[0], c.q[1], c.idx);
    swap1(c.idx, c.q);
  }
  c.err = gate(best.mi, c.q, err, REGIONS);
  if (c.err < best.err) best = c;
}

// ---- the whole search of one block
template <bool SG>
__device__ void search_block(const int (&h)[3][16], int topk, int iters, int shake, int mode_mask,
                             int fb, uint32_t (&words)[4], float& err_out) {
  Cand best2, best1;
  bool has2 = false, has1 = false;
  if (mode_mask & 0x3FF) {
    float ests[32];
#pragma unroll 1
    for (int j = 0; j < 32; ++j) ests[j] = estimate_shape<SG>(h, bc7::P2[j]);
#pragma unroll 1
    for (int r = 0; r < topk; ++r) {
      int sid = 0;
      float bst = ests[0];
#pragma unroll 1
      for (int j = 1; j < 32; ++j)
        if (ests[j] < bst) {
          bst = ests[j];
          sid = j;
        }
      ests[sid] = BIG;
      const uint32_t in1 = bc7::P2[sid];
      const int anchor = bc7::ANCHOR2[sid];
      float e[4][3];
      fit_masked<SG, 3>(h, ~in1 & 0xFFFFu, iters, e[0], e[1]);
      fit_masked<SG, 3>(h, in1, iters, e[2], e[3]);
      int cur = -1;
      Cand cand;
      cand.shape = sid;
      float err = 0.0f;
#pragma unroll 1
      for (int mi = 0; mi < 10; ++mi) {
        if (!((mode_mask >> mi) & 1)) continue;
        const int prec = MODES[mi].base_bits;
        if (prec != cur) {
          // a new precision group: quantise, both regions' palettes, swaps
          cur = prec;
          int u[4][3];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              cand.q[j][c] = quantize<SG>(e[j][c], prec);
              u[j][c] = unquantize<SG>(cand.q[j][c], prec);
            }
          cand.idx = 0;
          const float err0 = palette_err<SG, 3>(h, u[0], u[1], ~in1 & 0xFFFFu, cand.idx);
          const float err1 = palette_err<SG, 3>(h, u[2], u[3], in1, cand.idx);
          err = err0 + err1;
          swap2(cand.idx, in1, anchor, cand.q);
        }
        const float em = gate(mi, cand.q, err, 2);
        if (!has2 || em < best2.err) {
          best2 = cand;
          best2.err = em;
          best2.mi = mi;
          has2 = true;
        }
      }
    }
    if (shake) shake_best<SG, 2>(h, shake, best2);
  }
  if (mode_mask & 0x3C00) {
    float e0[3], e1[3];
    fit_masked<SG, 4>(h, 0xFFFFu, iters, e0, e1);
#pragma unroll 1
    for (int mi = 10; mi < 14; ++mi) {
      if (!((mode_mask >> mi) & 1)) continue;
      const int prec = MODES[mi].base_bits;
      Cand cand;
      cand.shape = 0;
      cand.mi = mi;
      int u0[3], u1[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        cand.q[0][c] = quantize<SG>(e0[c], prec);
        cand.q[1][c] = quantize<SG>(e1[c], prec);
        u0[c] = unquantize<SG>(cand.q[0][c], prec);
        u1[c] = unquantize<SG>(cand.q[1][c], prec);
      }
      cand.idx = 0;
      const float err = palette_err<SG, 4>(h, u0, u1, 0xFFFFu, cand.idx);
      swap1(cand.idx, cand.q);
      cand.err = gate(mi, cand.q, err, 1);
      if (!has1 || cand.err < best1.err) {
        best1 = cand;
        has1 = true;
      }
    }
    if (shake) shake_best<SG, 1>(h, shake, best1);
  }
  Cand best = has2 ? best2 : best1;
  if (has2 && has1 && best1.err < best2.err) best = best1;

  if (fb >= 0) {
    // every enabled mode is transformed: a solid-mean candidate fits any
    const int prec = MODES[fb].base_bits;
    Cand cand;
    int u[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s = work<SG>(h[c][0]);
#pragma unroll
      for (int p = 1; p < 16; ++p) s = s + work<SG>(h[c][p]);
      const int qm = quantize<SG>(s / 16.0f, prec);
      u[c] = unquantize<SG>(qm, prec);
#pragma unroll
      for (int j = 0; j < 4; ++j) cand.q[j][c] = qm;
    }
    u64 unused = 0;
    cand.err = MODES[fb].regions == 1 ? palette_err<SG, 4>(h, u, u, 0xFFFFu, unused)
                                      : palette_err<SG, 3>(h, u, u, 0xFFFFu, unused);
    cand.mi = fb;
    cand.shape = 0;
    cand.idx = 0;
    if (cand.err < best.err) best = cand;
  }

  // ---- pack the winner
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

// one block: load the 48 half-ints of block i, search, store
template <bool SG>
__device__ __forceinline__ void encode_block(const int* __restrict__ h, int64_t i, int topk,
                                             int iters, int shake, int mode_mask, int fb,
                                             uint32_t* __restrict__ words, float* __restrict__ err) {
  int x[3][16];
  const int* b = h + i * 48;
#pragma unroll
  for (int p = 0; p < 16; ++p)
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c][p] = b[p * 3 + c];
  uint32_t w[4];
  float e;
  search_block<SG>(x, topk, iters, shake, mode_mask, fb, w, e);
#pragma unroll
  for (int k = 0; k < 4; ++k) words[4 * i + k] = w[k];
  err[i] = e;
}

#ifdef __CUDACC__
// The kernel and its launcher; the host build of this header for the tests
// stops before them.
template <bool SG>
__global__ void __launch_bounds__(bcx::THREADS)
bc6h_kernel(const int* __restrict__ h, int64_t n, int topk, int iters, int shake, int mode_mask,
            int fb, uint32_t* __restrict__ words, float* __restrict__ err) {
  const int64_t i = bcx::block_index();
  if (i < n) encode_block<SG>(h, i, topk, iters, shake, mode_mask, fb, words, err);
}

// Launches the kernel on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take. `fb` is the
// mode index of the solid-mean fallback, or -1 (the host decides it from the
// mask: kernels/bc6h.py fallback_mode).
inline int launch(const int* h, long long n, int sg, int topk, int iters, int shake,
                  int mode_mask, int fb, uint32_t* words, float* err, void* stream) {
  if (topk < 1 || topk > 32 || iters < 0 || shake < 0 || !(mode_mask & 0x3FFF) ||
      fb < -1 || fb >= NMODES || (fb >= 0 && !((mode_mask >> fb) & 1)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sg)
    bc6h_kernel<true><<<bcx::grid_for(n), bcx::THREADS, 0, s>>>(h, n, topk, iters, shake,
                                                                 mode_mask, fb, words, err);
  else
    bc6h_kernel<false><<<bcx::grid_for(n), bcx::THREADS, 0, s>>>(h, n, topk, iters, shake,
                                                                  mode_mask, fb, words, err);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace bc6h
