// BC7 partition shortlist (K3): per block, an error estimate for every
// partition of a list and the k smallest. The device function lives here so a
// search kernel can call it in place of a second launch.
//
// What bounds it: operations. A block is 256 bytes in and 4*k bytes out
// against ~30 float operations per pixel and partition, 64 partitions deep.
// What the design does about it: one thread per block keeps the pixels in
// registers for the whole sweep; the partition loop stays rolled and reads
// the shape from __constant__ memory (uniform over the warp), the pixel and
// channel loops are unrolled and predicated on the shape's bit; the 64
// estimates are never stored - K running-best (value, slot) pairs give the
// same ids because equal values keep list order. K is a template on a small
// set of slot counts (4, 9, 16) so that the fast path's k = 4 keeps its
// registers while the full encoder's k = 9 (quality above 0.75 with
// performance below 1) and the overrides up to 16 still run.
//
// Bit-agreement with the plain version (kernels/bc7_est.py): sums run over the
// subset's pixels in pixel order (a skipped pixel is the same as adding +0),
// the reciprocal of the axis length is formed and then multiplied, rounding
// is half-to-even, and the file is built without multiply-add contraction.
#pragma once
#include "bc7_common.cuh"

namespace bc7 {

constexpr int MAX_K = 16;

// slot count of the instantiation that serves k ids
inline int slots_for(int k) { return k <= 4 ? 4 : (k <= 9 ? 9 : 16); }

struct PartList {
  int n;
  uint8_t id[64];
};

// Adds the estimate of one subset (pixels `mask`) to `est`.
template <int NC>
__device__ __forceinline__ void subset_estimate(const float (&x)[NC][16], uint32_t mask,
                                                float lm1, float inv_lm1, bool pca,
                                                float& est) {
  const int cnt_i = __popc(mask);
  if (cnt_i == 0) return;
  const float cnt = (float)cnt_i;
  float mean[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int p = 0; p < 16; ++p)
      if ((mask >> p) & 1u) acc = acc + x[c][p];
    mean[c] = acc / cnt;
  }
  float axis[NC];
  if (pca) {
    // covariance, upper triangle, then a ones-seeded power iteration
    float cov[NC][NC];
#pragma unroll
    for (int a = 0; a < NC; ++a)
#pragma unroll
      for (int b = a; b < NC; ++b) {
        float acc = 0.0f;
#pragma unroll
        for (int p = 0; p < 16; ++p)
          if ((mask >> p) & 1u) acc = acc + (x[a][p] - mean[a]) * (x[b][p] - mean[b]);
        cov[a][b] = acc;
        cov[b][a] = acc;
      }
#pragma unroll
    for (int c = 0; c < NC; ++c) axis[c] = 1.0f;
#pragma unroll 1
    for (int it = 0; it < 4; ++it) {
      float nv[NC];
      float n2 = 0.0f;
#pragma unroll
      for (int a = 0; a < NC; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int b = 0; b < NC; ++b) acc = acc + cov[a][b] * axis[b];
        nv[a] = acc;
        n2 = n2 + acc * acc;
      }
      const float n = sqrtf(n2);
      const bool ok = n > 1e-8f;
      const float inv = 1.0f / fmaxf(n, 1e-8f);
#pragma unroll
      for (int a = 0; a < NC; ++a) axis[a] = ok ? nv[a] * inv : axis[a];
    }
  } else {
    // diagonal of the residual bounding box
    float n2 = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float lo = INFINITY, hi = -INFINITY;
#pragma unroll
      for (int p = 0; p < 16; ++p)
        if ((mask >> p) & 1u) {
          const float v = x[c][p] - mean[c];
          lo = fminf(lo, v);
          hi = fmaxf(hi, v);
        }
      axis[c] = hi - lo;
      n2 = n2 + axis[c] * axis[c];
    }
    const float inv = 1.0f / fmaxf(sqrtf(n2), 1e-6f);
#pragma unroll
    for (int c = 0; c < NC; ++c) axis[c] = axis[c] * inv;
  }
  float t[16];
  float tmin = INFINITY, tmax = -INFINITY;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc = acc + (x[c][p] - mean[c]) * axis[c];
    t[p] = acc;
    if ((mask >> p) & 1u) {
      tmin = fminf(tmin, acc);
      tmax = fmaxf(tmax, acc);
    }
  }
  const float span = fmaxf(tmax - tmin, 1e-6f);
#pragma unroll
  for (int p = 0; p < 16; ++p)
    if ((mask >> p) & 1u) {
      const float tq = rintf((t[p] - tmin) / span * lm1);
      const float tr = tq * inv_lm1 * span + tmin;
      float d2 = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float v = x[c][p] - mean[c];
        d2 = d2 + v * v;
      }
      d2 = d2 - t[p] * t[p];
      const float dq = t[p] - tr;
      est = est + (d2 + dq * dq);
    }
}

// The k best partitions of `pl` for one block, best first, into ids[0..k),
// k <= K. Of equal estimates the one earlier in the list ranks first.
template <int NC, int K>
__device__ __forceinline__ void estimate_topk(const float (&x)[NC][16], int subsets,
                                              const PartList& pl, int levels, int k, bool pca,
                                              int* __restrict__ ids) {
  const float lm1 = (float)(levels - 1);
  const float inv_lm1 = (float)(1.0 / (double)(levels - 1));
  float bv[K];
  int bs[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    bv[r] = INFINITY;
    bs[r] = 0;
  }
#pragma unroll 1
  for (int j = 0; j < pl.n; ++j) {
    const int pid = pl.id[j];
    const uint32_t bits = subsets == 2 ? P2[pid] : P3[pid];
    float est = 0.0f;
#pragma unroll 1
    for (int s = 0; s < subsets; ++s)
      subset_estimate<NC>(x, subset_mask(bits, subsets, s), lm1, inv_lm1, pca, est);
    // stable insertion: once the new value has displaced an entry, every
    // later entry moves down one slot
    float v = est;
    int slot = j;
    bool carry = false;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      carry = carry || (v < bv[r]);
      if (carry) {
        const float tv = bv[r];
        const int ts = bs[r];
        bv[r] = v;
        bs[r] = slot;
        v = tv;
        slot = ts;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < K; ++r)
    if (r < k) ids[r] = pl.id[bs[r]];
}

}  // namespace bc7
