// BC7 partition shortlist (K3): per block, an error estimate for every
// partition of a list and the k smallest, in list order on ties.
//
// What bounds it: operations. A block is 256 bytes in and 4*k bytes out
// against ~30-40 float operations per pixel and partition, 16 to 64
// partitions deep.
//
// What the design does about it: a group of EST_LANES (8) lanes ranks one
// block; a CTA of 128 threads holds 16 groups. The group loads its block once
// into shared memory (float4 loads side by side), scaled to 0..255. The
// partitions are dealt to the lanes in the order `deal` (lane l takes deal
// steps l, l + 8, ...); a lane computes each of its partitions' estimate
// whole, with the plain version's arithmetic, and keeps its own K best by
// (value, list position), in registers. After the group's barrier lane 0
// merges the 8 lists: k times the smallest head by (value, list position). A
// subset's passes (mean, axis, projection extents, quantisation error) visit
// only its pixels, in ascending order, reading them from shared memory by
// index, so a partition costs 16 pixels per pass whatever its subsets. A
// warp's lanes loop as long as the
// largest of their subsets, so the caller deals the partitions sorted by
// their subsets' sizes (kernels/bc7_est.py:deal_order): the lanes that run
// side by side then have subsets of about the same size.
//
// A barred block (`bar[i]` set: the caller's mode needs no shortlist there)
// returns at once with the list's first k ids, what an all-equal ranking
// gives; the full BC7 search never reads them (bc7_full_search.cuh returns
// for a barred block before it reads its ids).
//
// Bit-agreement with the plain version (kernels/bc7_est.py): sums run over
// the subset's pixels in pixel order, from 0; the reciprocal of the axis
// length is formed and then multiplied; rounding is half-to-even; the file is
// built without multiply-add contraction. The merge equals one stable
// insertion over the whole list: the global k best by (value, position) are
// among the lanes' k best. An estimate that is NaN (a NaN pixel) or +inf is
// never ranked, as in that insertion; a block with fewer than k finite
// estimates fills the rest with the list's first id. The plain version's
// argmin ranks NaN differently, so a block with a NaN pixel may get other ids
// from the two; blocks in [0, 1] do not reach that case.
#pragma once
#include "bc7_common.cuh"

namespace bc7 {

constexpr int MAX_K = 16;
constexpr int EST_LANES = 8;              // lanes per block
constexpr int EST_THREADS = 128;          // threads per CTA
constexpr int EST_BLOCKS = EST_THREADS / EST_LANES;

// slot count of the instantiation that serves k ids
inline int slots_for(int k) { return k <= 4 ? 4 : (k <= 9 ? 9 : 16); }

struct PartList {
  int n;
  uint8_t id[64];     // the partitions, in list order
  uint8_t deal[64];   // list positions in the order they are dealt
};

// the group's shared state: the block (a pixel's channels in one float4,
// read with one load), then each lane's K best
template <int K>
struct EstShared {
  float4 x[16];
  float bv[EST_LANES][K];
  int bs[EST_LANES][K];
};

// channel c of a pixel
__device__ __forceinline__ float chan(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// The pixels of the subsets of packed shape `bits`: m[s] for s < subsets.
// For 3 subsets, the 2-bit subset ids are split into their low and high bit
// planes and the even bits compacted.
__device__ __forceinline__ uint32_t compact_even(uint32_t v) {
  v &= 0x55555555u;
  v = (v | (v >> 1)) & 0x33333333u;
  v = (v | (v >> 2)) & 0x0F0F0F0Fu;
  v = (v | (v >> 4)) & 0x00FF00FFu;
  v = (v | (v >> 8)) & 0x0000FFFFu;
  return v;
}

template <int S>
__device__ __forceinline__ void part_masks(uint32_t bits, uint32_t (&m)[3]) {
  if (S == 2) {
    m[0] = ~bits & 0xFFFFu;
    m[1] = bits & 0xFFFFu;
    m[2] = 0u;
  } else {
    const uint32_t lo = compact_even(bits), hi = compact_even(bits >> 1);
    m[0] = ~lo & ~hi & 0xFFFFu;
    m[1] = lo & ~hi;
    m[2] = ~lo & hi & 0xFFFFu;
  }
}

// f(p) for the set bits p of `mask`, ascending
template <class F>
__device__ __forceinline__ void each_pixel(uint32_t mask, F&& f) {
  for (uint32_t m = mask; m; m &= m - 1) f(__ffs((int)m) - 1);
}

// Adds the estimate of one subset (pixels `mask`) to `est`. x: the block in
// shared memory.
template <int NC>
__device__ __forceinline__ void subset_estimate(const float4 (&x)[16], uint32_t mask,
                                                float lm1, float inv_lm1, bool pca,
                                                float& est) {
  const int cnt_i = __popc(mask);
  if (cnt_i == 0) return;
  const float cnt = (float)cnt_i;
  float mean[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) mean[c] = 0.0f;
  each_pixel(mask, [&](int p) {
    const float4 v = x[p];
#pragma unroll
    for (int c = 0; c < NC; ++c) mean[c] = mean[c] + chan(v, c);
  });
#pragma unroll
  for (int c = 0; c < NC; ++c) mean[c] = mean[c] / cnt;
  float axis[NC];
  if (pca) {
    // covariance, upper triangle, then a ones-seeded power iteration
    float cov[NC][NC];
#pragma unroll
    for (int a = 0; a < NC; ++a)
#pragma unroll
      for (int b = a; b < NC; ++b) cov[a][b] = 0.0f;
    each_pixel(mask, [&](int p) {
      const float4 xp = x[p];
      float v[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) v[c] = chan(xp, c) - mean[c];
#pragma unroll
      for (int a = 0; a < NC; ++a)
#pragma unroll
        for (int b = a; b < NC; ++b) cov[a][b] = cov[a][b] + v[a] * v[b];
    });
#pragma unroll
    for (int a = 0; a < NC; ++a)
#pragma unroll
      for (int b = 0; b < a; ++b) cov[a][b] = cov[b][a];
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
    float lo[NC], hi[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      lo[c] = INFINITY;
      hi[c] = -INFINITY;
    }
    each_pixel(mask, [&](int p) {
      const float4 xp = x[p];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float v = chan(xp, c) - mean[c];
        lo[c] = fminf(lo[c], v);
        hi[c] = fmaxf(hi[c], v);
      }
    });
    float n2 = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      axis[c] = hi[c] - lo[c];
      n2 = n2 + axis[c] * axis[c];
    }
    const float inv = 1.0f / fmaxf(sqrtf(n2), 1e-6f);
#pragma unroll
    for (int c = 0; c < NC; ++c) axis[c] = axis[c] * inv;
  }
  // the projection of a pixel on the axis
  auto proj = [&](const float4& xp) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc = acc + (chan(xp, c) - mean[c]) * axis[c];
    return acc;
  };
  float tmin = INFINITY, tmax = -INFINITY;
  each_pixel(mask, [&](int p) {
    const float t = proj(x[p]);
    tmin = fminf(tmin, t);
    tmax = fmaxf(tmax, t);
  });
  const float span = fmaxf(tmax - tmin, 1e-6f);
  each_pixel(mask, [&](int p) {
    const float4 xp = x[p];
    const float t = proj(xp);
    const float tq = rintf((t - tmin) / span * lm1);
    const float tr = tq * inv_lm1 * span + tmin;
    float d2 = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float v = chan(xp, c) - mean[c];
      d2 = d2 + v * v;
    }
    d2 = d2 - t * t;
    const float dq = t - tr;
    est = est + (d2 + dq * dq);
  });
}

// (v, slot) before (bv, bs): the smaller value, then the earlier position
__device__ __forceinline__ bool ranks_before(float v, int slot, float bv, int bs) {
  return v < bv || (v == bv && slot < bs);
}

// K best (value, list position), smallest first: once the new pair has
// displaced an entry, every later entry moves down one slot. Unfilled slots
// hold (+inf, 0), so a NaN or +inf value is never kept.
template <int K>
__device__ __forceinline__ void topk_insert(float (&bv)[K], int (&bs)[K], float v, int slot) {
  bool carry = false;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    carry = carry || ranks_before(v, slot, bv[r], bs[r]);
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

// The k best partitions of `pl` (of S subsets) for block `px` (4 floats per
// pixel), best first, into ids[0..k), k <= K; `barred`: the list's first k;
// ids null: nothing written. Every group runs the same three phases, barred
// or not, so that a warp's barrier can be the whole warp's.
template <int NC, int K, int S, class Run>
__device__ __forceinline__ void est_block(EstShared<K>& sh, const float* __restrict__ px,
                                          bool barred, const PartList& pl, int levels, int k,
                                          bool pca, int* __restrict__ ids, Run&& run) {
  constexpr int L = EST_LANES;
  if (barred) {
    run([&](int lane) {
      if (ids)
        for (int r = lane; r < k; r += L) ids[r] = pl.id[r];
    });
    run([](int) {});
    run([](int) {});
    return;
  }
  run([&](int lane) {
    for (int p = lane; p < 16; p += L) {
      const float4 v = reinterpret_cast<const float4*>(px)[p];
      sh.x[p] = make_float4(v.x * 255.0f, v.y * 255.0f, v.z * 255.0f,
                            NC == 4 ? v.w * 255.0f : 0.0f);
    }
  });
  // each lane's partitions, whole, into its own K best
  run([&](int lane) {
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
    for (int t = lane; t < pl.n; t += L) {
      const int j = pl.deal[t];
      uint32_t m[3];
      part_masks<S>(S == 2 ? P2[pl.id[j]] : P3[pl.id[j]], m);
      float est = 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) subset_estimate<NC>(sh.x, m[s], lm1, inv_lm1, pca, est);
      topk_insert<K>(bv, bs, est, j);
    }
#pragma unroll
    for (int r = 0; r < K; ++r) {
      sh.bv[lane][r] = bv[r];
      sh.bs[lane][r] = bs[r];
    }
  });
  // the merge: k times the smallest head by (value, position)
  run([&](int lane) {
    if (lane || !ids) return;
    int head[L];
#pragma unroll
    for (int l = 0; l < L; ++l) head[l] = 0;
#pragma unroll 1
    for (int r = 0; r < k; ++r) {
      int best = 0;
      float v = sh.bv[0][head[0]];
      int s = sh.bs[0][head[0]];
#pragma unroll
      for (int l = 1; l < L; ++l) {
        const float vl = sh.bv[l][head[l]];
        const int sl = sh.bs[l][head[l]];
        if (ranks_before(vl, sl, v, s)) {
          best = l;
          v = vl;
          s = sl;
        }
      }
#pragma unroll
      for (int l = 0; l < L; ++l) head[l] += l == best ? 1 : 0;
      ids[r] = pl.id[s];
    }
  });
}

}  // namespace bc7
