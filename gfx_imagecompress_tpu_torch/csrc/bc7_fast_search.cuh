// Fast BC7 search (K4): mode 6 raced against mode 1 over a shortlist of
// partitions, the bc7enc16-style search of kernels/bc7_fast.py. Replaces the
// Pallas kernel gfx_imagecompress_tpu/kernels/bc7_fast_pallas.py:_bc7fast_kernel
// (:692, launched at :788).
//
// What bounds it: operations. A block is 256 bytes in, 4*K bytes of ids in
// and 20 bytes out against 10^5 float operations of fits, quantisations and
// exact palette evaluations: at the default budget mode 6's fit and 20
// refits, 8 partition-subset fits of mode 1, the single-colour candidate and
// 38 uber refits of mode 1's winner, each with an exact palette assign.
//
// What the design does about it: a group of FAST_LANES lanes encodes one
// block; a CTA holds several groups. Measured on the H100 at 2, 4, 8 and 16
// lanes (PERF.md): 2 is the fastest at every budget on a 1K image, the
// `fast` one included (more lanes idle more in the one-item phases). The group loads its block once (float4
// loads side by side) into shared memory, scaled to 0..255, and every lane
// reads pixels from there. The search is a sequence of phases, each dealing
// independent candidates to the lanes:
//   a. one item per (shortlisted partition, subset) of mode 1 (a chunk of
//      partitions at a time), mode 6's initial fit (step 0), and the
//      single-colour candidate; a block with alpha runs step 0 alone;
//   b. mode 6's refit from step 0's indices (step 1) on lane 0; beside it on
//      lane 1 the mode-1 scan over the chunk's partitions in list order, after
//      the last chunk the single-colour candidate, then the uber entries;
//   c. uber, one item per (group, variant): mode 6's variants of the indices
//      after step 1, then mode 1's subset 0's and subset 1's variants of the
//      winner's indices, in chunks of slots;
//   d. per chunk, one scan per group, the group's entry first;
//   e. the race of the two modes and the pack, on lane 0.
// A lane computes its candidate whole with the plain version's arithmetic and
// writes (error, state) to a slot; after the group's barrier the winner is
// picked by a scan of the slots in the sequential order with the sequential
// loops' compares (scan_min, uber_pick: strict <, the incumbent and then the
// earlier candidate keep ties). No sum is reordered.
// Why the groups are independent: mode 6's variants read only the indices
// after step 1 and fall back to the initial fit; a mode-1 subset's variants
// read and write only that subset's index fields and endpoints (the plain
// loop updates subset 0 before subset 1, and subset 1 reads none of what that
// update writes), so the two subsets' winners are kept apart (Chain<2>'s
// per-subset fields) and only the pack joins them.
// The fits, refits and assigns are the masked passes of bc7_group.cuh, shared
// with the full search: a pass visits only its subset's pixels; mode 6's
// passes are the counted 16-pixel loops. The metric is a template argument:
// perceptual (YCbCr, bc7enc16's weights) or RGB.
//
// The route is CUDA C++: integer bit-fields, data-dependent loops and
// per-lane branching. Tensor cores (wgmma) and TMA are not used: the arithmetic
// is scalar float32 with a fixed order of summation, which no matrix unit
// keeps, and a block reads only 256 bytes.
//
// Bit-agreement with the plain version: candidates in its order, strict <
// (first wins), sums over pixels left to right in pixel order, Python-double
// constants rounded once to float, rintf for half-to-even, no multiply-add
// contraction (build flag).
#pragma once
#include "bc7_group.cuh"

namespace bc7 {

// Launch shape with L lanes per block: SLOTS candidates per chunked phase
// (uber items, or SLOTS / 2 partitions of mode 1).
template <int L>
struct FastShape {
  enum {
    LANES = L,
    THREADS = L >= 4 ? 128 : 64,  // threads per CTA
    BLOCKS = THREADS / L,         // BC7 blocks per CTA
    MIN_CTAS = 512 / THREADS,     // CTAs per SM: at most 128 registers
    SLOTS = 4 * L,
  };
};

// the lanes per block of bc7_fast_encode (kernels/bc7_fast.py FAST_LANES)
constexpr int FAST_LANES = 2;

// ---- endpoint quantisation with p-bits
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
      const float diff = bcx::i2f(da[p][c]) - ec;
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
      const float fa = bcx::i2f(da0[p][c]) - a, fb = bcx::i2f(da1[p][c]) - b;
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

__device__ __forceinline__ int expand7(int q, int pb) {
  const int x = ((q << 1) | pb) << 1;
  return x | (x >> 7);
}

// mode 6: per-endpoint p-bits, 7-bit codes, one exact assign of all 16 pixels
template <bool PERC, class X>
__device__ __forceinline__ void quant6(const X& xs, const float (&e0)[4], const float (&e1)[4],
                                       Sub& out, u64& idx) {
  int q0[4], q1[4], d0[4], d1[4];
  pbit_endpoint(e0, q0, d0, out.p0);
  pbit_endpoint(e1, q1, d1, out.p1);
  out.q0 = out.q1 = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    setq(out.q0, c, q0[c]);
    setq(out.q1, c, q1[c]);
  }
  assign_sub<4, 0, 4, true, PERC>(xs, d0, d1, 0xFFFFu, idx, out.err);
}

// mode 1: 6-bit endpoints and a shared p-bit for the pixels of `mask`, one
// exact assign
template <bool PERC, class X>
__device__ __forceinline__ void quant1(const X& xs, uint32_t mask, const float (&e0)[3],
                                       const float (&e1)[3], Sub& out, u64& idx) {
  int q0[3], q1[3], d0[3], d1[3], pb;
  pbit_shared(e0, e1, q0, d0, q1, d1, pb);
  out.q0 = out.q1 = 0u;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    setq(out.q0, c, q0[c]);
    setq(out.q1, c, q1[c]);
  }
  out.p0 = out.p1 = pb;
  assign_sub<3, 0, 3, false, PERC>(xs, d0, d1, mask, idx, out.err);
}

// ---- the group's shared state
template <int L>
struct FastShared {
  float xs[4][16];      // the block scaled to 0..255
  float f0[4], f1[4];   // mode 6's initial fit, every refit's fallback
  Sub s6;               // mode 6's running best and its indices
  u64 idx6;
  Chain<2> st1;         // mode 1's running best
  Chain<2> solid;       // the single-colour candidate
  Entry ent[3];         // the uber groups: mode 6, mode 1's subsets 0 and 1
  Slot slot[FastShape<L>::SLOTS];
};

// ---- the items

// mode 1, partition `pid`, subset s: the masked fit and the quantisation
template <bool PERC, class X>
__device__ __forceinline__ void part_item(const X& xs, int pid, int s, Slot& out) {
  const uint32_t bits = P2[pid];
  const uint32_t mask = s ? (bits & 0xFFFFu) : (~bits & 0xFFFFu);
  float e0[3], e1[3];
  fit_sub<3, 3, false>(xs, mask, 2, e0, e1);
  quant1<PERC>(xs, mask, e0, e1, out.s, out.idx);
}

// mode 6, step 0: the initial fit, kept as the refits' fallback
template <int L, bool PERC>
__device__ __forceinline__ void mode6_fit(FastShared<L>& sh) {
  fit_sub<4, 4, true>(sh.xs, 0xFFFFu, 2, sh.f0, sh.f1);
  quant6<PERC>(sh.xs, sh.f0, sh.f1, sh.s6, sh.idx6);
}

// mode 6, step 1: a refit from step 0's indices, kept on a strict <; then the
// uber entry, the indices after it
template <int L, bool PERC>
__device__ __forceinline__ void mode6_refit(FastShared<L>& sh, int nvar) {
  float e0[4], e1[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    e0[c] = sh.f0[c];
    e1[c] = sh.f1[c];
  }
  refit_sub<4, 4, true>(sh.xs, sh.idx6, 0xFFFFu, e0, e1);
  Sub c;
  u64 ci;
  quant6<PERC>(sh.xs, e0, e1, c, ci);
  if (c.err < sh.s6.err) {
    sh.s6 = c;
    sh.idx6 = ci;
  }
  if (nvar) {
    Entry& e = sh.ent[0];
    e.base = sh.idx6;
    e.mask = 0xFFFFu;
    index_extremes(e.base, e.mask, e.mn, e.mx);
  }
}

// whole-block single-colour candidate: partition 0, both subsets the optimal
// table endpoints of the block's mean colour (the sums of the unscaled RGB
// pixels, read again from device memory in pixel order); each subset's error
// its own masked assign
template <int L, bool PERC>
__device__ __forceinline__ void solid_item(FastShared<L>& sh, const float* __restrict__ x) {
  const float4* p4 = reinterpret_cast<const float4*>(x);
  float raw[3];
#pragma unroll 1
  for (int p = 0; p < 16; ++p) {
    const float4 v = p4[p];
    raw[0] = p ? raw[0] + v.x : v.x;
    raw[1] = p ? raw[1] + v.y : v.y;
    raw[2] = p ? raw[2] + v.z : v.z;
  }
  int cv[3];
  int e[2] = {0, 0};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    cv[c] = (int)fminf(fmaxf(rintf(raw[c] / 16.0f * 255.0f), 0.0f), 255.0f);
    e[0] += (int)(SOLID1[2 * cv[c]] >> 16);
    e[1] += (int)(SOLID1[2 * cv[c] + 1] >> 16);
  }
  const int pb = e[1] < e[0] ? 1 : 0;
  Chain<2>& out = sh.solid;
  Sub s;
  s.q0 = s.q1 = 0u;
  s.p0 = s.p1 = pb;
  int d0[3], d1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint32_t t = SOLID1[2 * cv[c] + pb];
    setq(s.q0, c, (int)(t & 0xFFu));
    setq(s.q1, c, (int)((t >> 8) & 0xFFu));
    d0[c] = expand7(getq(s.q0, c), pb);
    d1[c] = expand7(getq(s.q1, c), pb);
  }
  out.pid = 0;
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {
    out.s[k] = s;
    const uint32_t mask = k ? (P2[0] & 0xFFFFu) : (~P2[0] & 0xFFFFu);
    assign_sub<3, 0, 3, false, PERC>(sh.xs, d0, d1, mask, out.idx[k], out.s[k].err);
  }
  out.err = out.s[0].err + out.s[1].err;
}

// the mode-1 scan over a chunk's partitions k0.. in list order (the first
// partition of the list taken as is, strict < after); after the last chunk
// the single-colour candidate on a strict <, then the uber entries
template <int L>
__device__ __forceinline__ void mode1_scan(FastShared<L>& sh, const int* __restrict__ ids,
                                           int k0, int nk, bool last, int nvar) {
  Chain<2>& st = sh.st1;
#pragma unroll 1
  for (int kk = 0; kk < nk; ++kk) {
    const Slot& a = sh.slot[2 * kk];
    const Slot& b = sh.slot[2 * kk + 1];
    const float e = a.s.err + b.s.err;
    if (k0 + kk == 0 || e < st.err) {
      st.err = e;
      st.pid = ids[k0 + kk];
      st.s[0] = a.s;
      st.s[1] = b.s;
      st.idx[0] = a.idx;
      st.idx[1] = b.idx;
    }
  }
  if (!last) return;
  if (sh.solid.err < st.err) st = sh.solid;
  if (!nvar) return;
  const uint32_t bits = P2[st.pid];
#pragma unroll 1
  for (int s = 0; s < 2; ++s) {
    Entry& e = sh.ent[1 + s];
    e.s = st.s[s];
    e.base = st.idx[s];
    e.mask = s ? (bits & 0xFFFFu) : (~bits & 0xFFFFu);
    index_extremes(e.base, e.mask, e.mn, e.mx);
  }
}

// uber item v of group g: g = 0 mode 6 (refit from the variant, falling back
// to the initial fit), g = 1, 2 mode 1's subset g - 1 (falling back to the
// entry's decoded endpoints); ok = 0 for the identity variant, skipped
template <int L, bool PERC>
__device__ __forceinline__ void uber_item(const FastShared<L>& sh, int g, int v, int q,
                                          Slot& out) {
  const Entry& e = sh.ent[g];
  u64 src;
  if (g == 0) {
    out.ok = sel_variant<true>(e.base, 0xFFFFu, v, q, 15, e.mn, e.mx, src) ? 1 : 0;
    if (!out.ok) return;
    float e0[4], e1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      e0[c] = sh.f0[c];
      e1[c] = sh.f1[c];
    }
    refit_sub<4, 4, true>(sh.xs, src, 0xFFFFu, e0, e1);
    quant6<PERC>(sh.xs, e0, e1, out.s, out.idx);
  } else {
    out.ok = sel_variant<false>(e.base, e.mask, v, q, 7, e.mn, e.mx, src) ? 1 : 0;
    if (!out.ok) return;
    float e0[3], e1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      e0[c] = bcx::i2f(expand7(getq(e.s.q0, c), e.s.p0));
      e1[c] = bcx::i2f(expand7(getq(e.s.q1, c), e.s.p0));
    }
    refit_sub<3, 3, false>(sh.xs, src, e.mask, e0, e1);
    quant1<PERC>(sh.xs, e.mask, e0, e1, out.s, out.idx);
  }
}

// ---- packing
__device__ __forceinline__ Bits128 pack_mode6(const Sub& st, u64 st_idx) {
  // anchor fix-up: the index MSB of pixel 0 must be 0
  const bool need = (get4(st_idx, 0) & 8) != 0;
  const u64 idx = need ? ~st_idx : st_idx;          // 15 - i in every field
  Bits128 b = {0ull, 0ull};
  put(b, 0x40, 0, 8);
  int pos = 7;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    put(b, getq(need ? st.q1 : st.q0, c), pos, 7);
    put(b, getq(need ? st.q0 : st.q1, c), pos + 7, 7);
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

__device__ __forceinline__ Bits128 pack_mode1(const Chain<2>& st) {
  const int anchor = ANCHOR2[st.pid];
  const u64 nib1 = nibble_mask(P2[st.pid] & 0xFFFFu);       // subset 1's fields
  u64 idx = st.idx[0] | st.idx[1];
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
    put(b, getq(need0 ? st.s[0].q1 : st.s[0].q0, c), pos, 6);
    put(b, getq(need0 ? st.s[0].q0 : st.s[0].q1, c), pos + 6, 6);
    put(b, getq(need1 ? st.s[1].q1 : st.s[1].q0, c), pos + 12, 6);
    put(b, getq(need1 ? st.s[1].q0 : st.s[1].q1, c), pos + 18, 6);
    pos += 24;
  }
  put(b, st.s[0].p0, 80, 1);
  put(b, st.s[1].p0, 81, 1);
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

// ---- one block on the group's shared struct: x the (N,16,4) blocks in [0,1],
// ids the (N,nids) shortlist. A block with any alpha below 255 (scaled) takes
// mode 6, which runs alone; an opaque one races mode 1 against it.
template <int L, bool PERC, class Run>
__device__ __forceinline__ void fast_block(FastShared<L>& sh, const float* __restrict__ x,
                                           int64_t i, const int* __restrict__ ids, int nids,
                                           int uber, uint4* __restrict__ words,
                                           float* __restrict__ err, Run&& run) {
  constexpr int SLOTS = FastShape<L>::SLOTS, KC = SLOTS / 2;
  const float* xb = x + i * 64;
  run([&](int lane) {
#pragma unroll 1
    for (int p = lane; p < 16; p += L) {
      const float4 v = reinterpret_cast<const float4*>(xb)[p];
      sh.xs[0][p] = v.x * 255.0f;
      sh.xs[1][p] = v.y * 255.0f;
      sh.xs[2][p] = v.z * 255.0f;
      sh.xs[3][p] = v.w * 255.0f;
    }
  });
  float amin = sh.xs[3][0];
#pragma unroll
  for (int p = 1; p < 16; ++p) amin = fminf(amin, sh.xs[3][p]);
  const bool opaque = !(amin < 254.999f);
  const int* bid = ids + i * nids;
  const int np = opaque ? nids : 0;
  int q;
  const int nvar = variant_slots(uber, q);

  // a and b, a chunk of KC partitions at a time; the first chunk also runs
  // mode 6's step 0 and the single-colour candidate, its scan phase mode 6's
  // step 1
#pragma unroll 1
  for (int k0 = 0; k0 == 0 || k0 < np; k0 += KC) {
    const int nk = min(KC, np - k0);
    const int nt = 2 * nk + (k0 ? 0 : (opaque ? 2 : 1));
    run([&](int lane) {
#pragma unroll 1
      for (int t = lane; t < nt; t += L) {
        if (t < 2 * nk)
          part_item<PERC>(sh.xs, bid[k0 + t / 2], t % 2, sh.slot[t]);
        else if (t == 2 * nk)
          mode6_fit<L, PERC>(sh);
        else
          solid_item<L, PERC>(sh, xb);
      }
    });
    run([&](int lane) {
      if (k0 == 0 && lane == 0) mode6_refit<L, PERC>(sh, nvar);
      if (nk > 0 && lane == (L > 1 ? 1 : 0))
        mode1_scan<L>(sh, bid, k0, nk, k0 + KC >= np, nvar);
    });
  }

  // c and d: uber, groups 0 (mode 6) and, opaque, 1 and 2 (mode 1's subsets),
  // each group's variants side by side, in chunks of SLOTS
  if (nvar) {
    const int ng = opaque ? 3 : 1, total = ng * nvar;
#pragma unroll 1
    for (int t0 = 0; t0 < total; t0 += SLOTS) {
      const int nt = min(SLOTS, total - t0);
      run([&](int lane) {
#pragma unroll 1
        for (int t = lane; t < nt; t += L)
          uber_item<L, PERC>(sh, (t0 + t) / nvar, (t0 + t) % nvar, q, sh.slot[t]);
      });
      run([&](int lane) {
#pragma unroll 1
        for (int g = lane; g < ng; g += L) {
          if (g == 0)
            uber_pick(sh.slot, t0, nt, 0, nvar, sh.s6, sh.idx6);
          else
            uber_pick(sh.slot, t0, nt, g, nvar, sh.st1.s[g - 1], sh.st1.idx[g - 1]);
        }
      });
    }
  }

  // e: mode 1's error over its subsets in order, the race (mode 6 keeps a
  // tie), the pack
  run([&](int lane) {
    if (lane != 0) return;
    Bits128 out = pack_mode6(sh.s6, sh.idx6);
    float e = sh.s6.err;
    if (opaque) {
      const float e1 = sh.st1.s[0].err + sh.st1.s[1].err;
      if (e1 < e) {
        out = pack_mode1(sh.st1);
        e = e1;
      }
    }
    words[i] = make_uint4((uint32_t)out.lo, (uint32_t)(out.lo >> 32), (uint32_t)out.hi,
                          (uint32_t)(out.hi >> 32));
    err[i] = e;
  });
}

#ifdef __CUDACC__
// The kernel and its launcher; the host build of this header for the tests
// stops before them. Group `grp` of the CTA encodes block
// blockIdx.x * BLOCKS + grp; its phases run through GroupRun.
template <int L, bool PERC>
__global__ void __launch_bounds__(FastShape<L>::THREADS, FastShape<L>::MIN_CTAS)
bc7_fast_kernel(const float* __restrict__ x, int64_t n, const int* __restrict__ ids, int nids,
                int uber, uint4* __restrict__ words, float* __restrict__ err) {
  constexpr int B = FastShape<L>::BLOCKS;
  __shared__ FastShared<L> sh[B];
  const int grp = threadIdx.x / L;
  const int64_t i = (int64_t)blockIdx.x * B + grp;
  if (i >= n) return;
  fast_block<L, PERC>(sh[grp], x, i, ids, nids, uber, words, err,
                      GroupRun<L>(grp, threadIdx.x % L));
}

// Launches the kernel with L lanes per block on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not take.
template <int L>
inline int launch_fast(const float* x, long long n, const int* ids, int nids, int perceptual,
                       int uber, uint32_t* words, float* err, void* stream) {
  if (int rc = bcx::check_args(x, 4)) return rc;
  if (nids < 1 || uber < 0) return (int)cudaErrorInvalidValue;
  constexpr int B = FastShape<L>::BLOCKS, T = FastShape<L>::THREADS;
  const unsigned grid = (unsigned)((n + B - 1) / B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* w = reinterpret_cast<uint4*>(words);
  if (perceptual)
    bc7_fast_kernel<L, true><<<grid, T, 0, s>>>(x, n, ids, nids, uber, w, err);
  else
    bc7_fast_kernel<L, false><<<grid, T, 0, s>>>(x, n, ids, nids, uber, w, err);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace bc7
