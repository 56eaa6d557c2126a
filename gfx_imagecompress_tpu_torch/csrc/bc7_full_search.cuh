// Full BC7 search (K5): one mode of the AMD-path search per block, the search
// of kernels/bc7_full.py (and of the JAX package's bc7_full_pallas.py
// _mode_kernel).
//
// What bounds it: operations. A block is 256 bytes in, 4*K bytes of ids in and
// 20 bytes out against 10^5-10^6 float operations per mode at the top tier:
// per shortlisted partition and subset a PCA fit and a p-bit race with exact
// palette assigns, then on the winner (and the runner-up, "keep-2") up to 38
// uber variants, each refit and requantised, and 3 rounds of a 24-step shake
// cube per channel.
// What the design does about it: one thread per block, one template
// instantiation per mode (its own constants, registers and launch), the 64
// pixel floats in registers for the whole search. The 16 indices of a block
// travel in one 64-bit word (4 bits each), so the anchor read, the index
// complement and the selector variants need no array; endpoint codes travel
// as 8-bit fields of one 32-bit word per endpoint. Partition, subset, variant,
// step and rotation loops stay rolled with one call site per heavy function;
// pixel and channel loops are unrolled, and a masked pass visits only its
// subset's pixels. The dual modes rotate the block in place (a swap of two
// channel rows) instead of holding a rotated copy.
//
// Bit-agreement with the plain version: candidates in its order, strict <
// (first wins), sums over pixels left to right in pixel order, Python-double
// constants rounded once to float, rintf for half-to-even, no multiply-add
// contraction (build flag).
#pragma once
#include "bc7_fast_search.cuh"

namespace bc7 {

// ---- per-mode constants: subsets, channels searched (the opaque modes 0-3
// search RGB and pay for alpha afterwards), colour / alpha endpoint bits,
// p-bits (0 none, 1 shared per subset, 2 per endpoint), index bits (the
// second field's for the dual modes), partition bits, index-selection choices
template <int M>
struct Mode;
// clang-format off
template <> struct Mode<0> { enum { S = 3, NC = 3, CB = 4, AB = 0, PB = 2, IB = 3, IB2 = 0, PART = 4, NSEL = 1 }; };
template <> struct Mode<1> { enum { S = 2, NC = 3, CB = 6, AB = 0, PB = 1, IB = 3, IB2 = 0, PART = 6, NSEL = 1 }; };
template <> struct Mode<2> { enum { S = 3, NC = 3, CB = 5, AB = 0, PB = 0, IB = 2, IB2 = 0, PART = 6, NSEL = 1 }; };
template <> struct Mode<3> { enum { S = 2, NC = 3, CB = 7, AB = 0, PB = 2, IB = 2, IB2 = 0, PART = 6, NSEL = 1 }; };
template <> struct Mode<4> { enum { S = 1, NC = 4, CB = 5, AB = 6, PB = 0, IB = 2, IB2 = 3, PART = 0, NSEL = 2 }; };
template <> struct Mode<5> { enum { S = 1, NC = 4, CB = 7, AB = 8, PB = 0, IB = 2, IB2 = 2, PART = 0, NSEL = 1 }; };
template <> struct Mode<6> { enum { S = 1, NC = 4, CB = 7, AB = 7, PB = 2, IB = 4, IB2 = 0, PART = 0, NSEL = 1 }; };
template <> struct Mode<7> { enum { S = 2, NC = 4, CB = 5, AB = 5, PB = 2, IB = 2, IB2 = 0, PART = 6, NSEL = 1 }; };
// clang-format on

constexpr float BIG = 3.4e38f;

// endpoint codes, 8 bits per channel in one word
__device__ __forceinline__ int getq(uint32_t q, int c) { return (int)((q >> (8 * c)) & 255u); }
__device__ __forceinline__ void setq(uint32_t& q, int c, int v) {
  q = (q & ~(255u << (8 * c))) | ((uint32_t)v << (8 * c));
}

// every index field of a 64-bit index word set to `v`
__device__ __forceinline__ u64 all_fields(int v) { return 0x1111111111111111ull * (u64)v; }

// float endpoint 0..255 -> BITS-bit code and its decoded 8-bit value
template <int BITS>
__device__ __forceinline__ void quant_plain(float e, int& q, int& deq) {
  constexpr int scale = (1 << BITS) - 1;
  const float r = rintf(e * (float)((double)scale / 255.0));
  q = (int)fminf(fmaxf(r, 0.0f), (float)scale);
  deq = (q << (8 - BITS)) | (q >> (2 * BITS - 8));
}

// code (and p-bit) -> decoded 8-bit value
template <int BITS, int PB>
__device__ __forceinline__ int deq_ch(int q, int p) {
  if constexpr (PB == 0) {
    return (q << (8 - BITS)) | (q >> (2 * BITS - 8));
  } else {
    constexpr int tb = BITS + 1;
    const int full = (q << 1) | p;
    return (full << (8 - tb)) | (full >> (2 * tb - 8));
  }
}

// p-bit combinations of a subset: per endpoint 4, shared 2, none 1
template <int PB>
struct Combos {
  enum { N = PB == 2 ? 4 : (PB == 1 ? 2 : 1) };
};
// p-bits of combination cb: (0,0) (0,1) (1,0) (1,1) per endpoint, (0,0) (1,1)
// shared
template <int PB>
__device__ __forceinline__ int combo_p0(int cb) {
  return PB == 2 ? cb >> 1 : cb;
}
template <int PB>
__device__ __forceinline__ int combo_p1(int cb) {
  return PB == 2 ? cb & 1 : cb;
}

// ---- endpoints and indices of one subset
struct Sub {
  float err;
  uint32_t q0, q1;  // codes per channel
  int p0, p1;       // p-bits (0 without)
};

// Exact palette assign of the pixels of `mask`, RGB(A) metric, channels
// C0..C0+NC-1: the projection index, the distance to the entry it selects.
template <int NC, int C0, int IB>
__device__ __forceinline__ void assign_sub(const float (&xs)[4][16], const int (&d0)[NC],
                                           const int (&d1)[NC], uint32_t mask, u64& idx,
                                           float& err) {
  if constexpr (C0 == 0) {
    float unused;
    assign_exact<NC, IB, false>(xs, false, d0, d1, mask, idx, err, unused);
  } else {
    static_assert(NC == 1 && C0 == 3, "a scalar assign reads the alpha row");
    const float e0[1] = {(float)d0[0]}, e1[1] = {(float)d1[0]};
    Proj<1> pr;
    make_proj<1>(e0, e1, false, true, pr);
    idx = 0;
    err = 0.0f;
#pragma unroll
    for (int p = 0; p < 16; ++p)
      if ((mask >> p) & 1u) {
        const float px[1] = {xs[3][p]};
        const int i = proj_index<1, IB>(pr, px);
        const float diff = xs[3][p] - (float)lerp64(d0[0], d1[0], weight<IB>(i));
        idx |= (u64)i << (4 * p);
        err = err + 1.0f * diff * diff;
      }
  }
}

// Quantise one subset's float endpoints against the exact palette. Without
// p-bits: plain codes, one assign. With p-bits: the combinations raced by the
// endpoints' rounding error, the winner assigned exactly - and with race 2 the
// best loser too, the smaller error winning (first on a tie).
template <int NC, int CB, int PB, int IB>
__device__ __forceinline__ void quant_subset(const float (&xs)[4][16], uint32_t mask,
                                             const float (&e0)[NC], const float (&e1)[NC],
                                             int race, Sub& out, u64& idx) {
  if constexpr (PB == 0) {
    int d0[NC], d1[NC];
    out.q0 = out.q1 = 0u;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      int q;
      quant_plain<CB>(e0[c], q, d0[c]);
      setq(out.q0, c, q);
      quant_plain<CB>(e1[c], q, d1[c]);
      setq(out.q1, c, q);
    }
    out.p0 = out.p1 = 0;
    assign_sub<NC, 0, IB>(xs, d0, d1, mask, idx, out.err);
  } else {
    float a[NC], b[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      a[c] = clamp255(e0[c]);
      b[c] = clamp255(e1[c]);
    }
    int pk = 0, pk2 = 0;
    float pe = 0.0f, pe2 = 0.0f;
    bool have2 = false;
#pragma unroll
    for (int cb = 0; cb < Combos<PB>::N; ++cb) {
      float perr = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        int q, d0, d1;
        quant_pbit<CB>(a[c], combo_p0<PB>(cb), q, d0);
        quant_pbit<CB>(b[c], combo_p1<PB>(cb), q, d1);
        const float f0 = (float)d0 - a[c], f1 = (float)d1 - b[c];
        perr = perr + (f0 * f0 + f1 * f1);
      }
      if (cb == 0) {
        pe = perr;
        continue;
      }
      const bool take = perr < pe;
      const int lk = take ? pk : cb;
      const float le = take ? pe : perr;
      if (take) {
        pk = cb;
        pe = perr;
      }
      if (race > 1 && (!have2 || le < pe2)) {
        pk2 = lk;
        pe2 = le;
        have2 = true;
      }
    }
#pragma unroll 1
    for (int r = 0; r < (race > 1 ? 2 : 1); ++r) {
      const int cb = r ? pk2 : pk;
      Sub c;
      c.p0 = combo_p0<PB>(cb);
      c.p1 = combo_p1<PB>(cb);
      c.q0 = c.q1 = 0u;
      int d0[NC], d1[NC];
#pragma unroll
      for (int ch = 0; ch < NC; ++ch) {
        int q;
        quant_pbit<CB>(a[ch], c.p0, q, d0[ch]);
        setq(c.q0, ch, q);
        quant_pbit<CB>(b[ch], c.p1, q, d1[ch]);
        setq(c.q1, ch, q);
      }
      u64 ci;
      assign_sub<NC, 0, IB>(xs, d0, d1, mask, ci, c.err);
      if (r == 0 || c.err < out.err) {
        out = c;
        idx = ci;
      }
    }
  }
}

// Uber selector rounds on one subset: the variants come from the indices at
// entry, each is refit by least squares (falling back to the entry's decoded
// endpoints) and requantised; the smallest error wins, the entry on a tie.
template <int NC, int CB, int PB, int IB>
__device__ __forceinline__ void uber_subset(const float (&xs)[4][16], uint32_t mask, int uber,
                                            int race, Sub& st, u64& idx) {
  int q;
  const int nvar = variant_slots(uber, q);
  float d0[NC], d1[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    d0[c] = (float)deq_ch<CB, PB>(getq(st.q0, c), st.p0);
    d1[c] = (float)deq_ch<CB, PB>(getq(st.q1, c), st.p1);
  }
  const u64 base = idx, nib = nibble_mask(mask);
  int mn, mx;
  index_extremes(base, mask, mn, mx);
  Sub best = st;
  u64 best_idx = base;
#pragma unroll 1
  for (int v = 0; v < nvar; ++v) {
    u64 src;
    if (!selector_variant(base, mask, v, q, (1 << IB) - 1, mn, mx, src)) continue;
    float e0[NC], e1[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      e0[c] = d0[c];
      e1[c] = d1[c];
    }
    lsq_refit<NC, IB>(xs, src, mask, e0, e1);
    Sub c;
    u64 ci;
    quant_subset<NC, CB, PB, IB>(xs, mask, e0, e1, race, c, ci);
    if (c.err < best.err) {
      best = c;
      best_idx = (base & ~nib) | ci;
    }
  }
  st = best;
  idx = best_idx;
}

// The shake of one subset, channels C0..C0+NC-1 with BITS-bit codes. Per
// round: the weights come from the indices at its start; channel by channel
// the endpoint steps (da, db) in [-srange, srange]^2 are tried around the
// round's start codes in order (the start first, strict < after); then the
// p-bit combinations are re-raced by an exact assign and the subset's indices
// requantised. The error is the re-race's.
template <int NC, int C0, int BITS, int PB, int IB>
__device__ __forceinline__ void shake_subset(const float (&xs)[4][16], uint32_t mask, int rounds,
                                             int srange, Sub& st, u64& idx) {
  constexpr int MAXQ = (1 << BITS) - 1;
  const int side = 2 * srange + 1, centre = (side * side) / 2;
  const u64 nib = nibble_mask(mask);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const u64 widx = idx;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int q0c = getq(st.q0, c), q1c = getq(st.q1, c);
      float best_e = 0.0f;
      int b0 = q0c, b1 = q1c;
#pragma unroll 1
      for (int j = 0; j < side * side; ++j) {
        int da = 0, db = 0;
        if (j > 0) {
          const int k = (j - 1) + ((j - 1) >= centre ? 1 : 0);
          da = k / side - srange;
          db = k % side - srange;
        }
        const int nq0 = bcx::clamp_i(q0c + da, 0, MAXQ), nq1 = bcx::clamp_i(q1c + db, 0, MAXQ);
        const int d0 = deq_ch<BITS, PB>(nq0, st.p0), d1 = deq_ch<BITS, PB>(nq1, st.p1);
        float e = 0.0f;
#pragma unroll
        for (int p = 0; p < 16; ++p)
          if ((mask >> p) & 1u) {
            const float diff =
                (float)lerp64(d0, d1, weight<IB>(get4(widx, p))) - xs[C0 + c][p];
            e = e + 1.0f * diff * diff;
          }
        if (j == 0 || e < best_e) {
          best_e = e;
          b0 = nq0;
          b1 = nq1;
        }
      }
      setq(st.q0, c, b0);
      setq(st.q1, c, b1);
    }
    float best_ne = 0.0f;
    int bp0 = st.p0, bp1 = st.p1;
    u64 bidx = 0;
#pragma unroll 1
    for (int cb = 0; cb < Combos<PB>::N; ++cb) {
      const int np0 = PB == 0 ? st.p0 : combo_p0<PB>(cb);
      const int np1 = PB == 0 ? st.p1 : combo_p1<PB>(cb);
      int d0[NC], d1[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        d0[c] = deq_ch<BITS, PB>(getq(st.q0, c), np0);
        d1[c] = deq_ch<BITS, PB>(getq(st.q1, c), np1);
      }
      u64 ni;
      float ne;
      assign_sub<NC, C0, IB>(xs, d0, d1, mask, ni, ne);
      if (cb == 0 || ne < best_ne) {
        best_ne = ne;
        bp0 = np0;
        bp1 = np1;
        bidx = ni;
      }
    }
    st.err = best_ne;
    st.p0 = bp0;
    st.p1 = bp1;
    idx = (idx & ~nib) | bidx;
  }
}

// ------------------------------------------------------ single-index modes ---
template <int S>
struct StateS {
  float err;
  int pid;
  u64 idx;
  Sub s[S];
};

template <int S>
__device__ __forceinline__ uint32_t shape_bits(int pid) {
  return S == 1 ? 0u : (S == 2 ? P2[pid] : P3[pid]);
}

template <int S>
__device__ __forceinline__ uint32_t subset_of(uint32_t bits, int s) {
  return S == 1 ? 0xFFFFu : subset_mask(bits, S, s);
}

// Modes 0/1/2/3/6/7: every shortlisted partition fitted and quantised per
// subset; the best (and for the 5-bit-or-less multi-subset modes the
// runner-up too) refined per subset by uber rounds and the shake. ids: the
// block's shortlist, or null for partitions 0..nids-1.
template <int M>
__device__ __forceinline__ void single_mode(const float (&xs)[4][16], const int* ids, int nids,
                                            int iters, int shake, int uber,
                                            StateS<Mode<M>::S>& best) {
  using T = Mode<M>;
  constexpr int S = T::S, NC = T::NC, CB = T::CB, PB = T::PB, IB = T::IB;
  const int nparts = S == 1 ? 1 : nids;
  const bool keep2 = CB <= 5 && S >= 2 && nparts > 1 && (uber || shake);
  // mode 0: the best two p-bit combinations raced exactly, two more uber levels
  constexpr bool low4 = CB <= 4 && PB != 0;
  const int race = low4 ? 2 : 1;
  if (low4 && uber) uber += 2;
  StateS<S> best2;
  bool have2 = false;
#pragma unroll 1
  for (int k = 0; k < nparts; ++k) {
    StateS<S> c;
    c.pid = S == 1 ? 0 : (ids ? ids[k] : k);
    c.idx = 0;
    c.err = 0.0f;
    const uint32_t bits = shape_bits<S>(c.pid);
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      const uint32_t mask = subset_of<S>(bits, s);
      float e0[NC], e1[NC];
      fit_line<NC, IB>(xs, mask, false, iters, e0, e1);
      u64 idx;
      quant_subset<NC, CB, PB, IB>(xs, mask, e0, e1, race, c.s[s], idx);
      c.idx |= idx;
      c.err = c.err + c.s[s].err;
    }
    if (k == 0) {
      best = c;
    } else if (keep2) {
      const bool take = c.err < best.err;
      const StateS<S> loser = take ? best : c;
      if (take) best = c;
      if (!have2 || loser.err < best2.err) {
        best2 = loser;
        have2 = true;
      }
    } else if (c.err < best.err) {
      best = c;
    }
  }
  if (!(uber || shake)) return;
#pragma unroll 1
  for (int r = 0; r < (keep2 ? 2 : 1); ++r) {
    StateS<S> st = r ? best2 : best;
    const uint32_t bits = shape_bits<S>(st.pid);
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      const uint32_t mask = subset_of<S>(bits, s);
      if (uber) uber_subset<NC, CB, PB, IB>(xs, mask, uber, race, st.s[s], st.idx);
      if (shake)
        shake_subset<NC, 0, CB, PB, IB>(xs, mask, shake, shake >= 3 ? 2 : 1, st.s[s], st.idx);
    }
    st.err = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) st.err = st.err + st.s[s].err;
    if (r == 0 || st.err < best.err) best = st;
  }
}

// Anchor fix-ups (a subset whose anchor index has its MSB set gets its indices
// complemented and its endpoints and p-bits swapped), then the fields.
template <int M>
__device__ __forceinline__ Bits128 pack_single(const StateS<Mode<M>::S>& st) {
  using T = Mode<M>;
  constexpr int S = T::S, CB = T::CB, AB = T::AB, PB = T::PB, IB = T::IB;
  constexpr int MSB = 1 << (IB - 1);
  const int a1 = S == 2 ? ANCHOR2[st.pid] : (S == 3 ? ANCHOR3_1[st.pid] : 0);
  const int a2 = S == 3 ? ANCHOR3_2[st.pid] : 0;
  const uint32_t bits = shape_bits<S>(st.pid);
  u64 idx = st.idx;
  uint32_t q0[S], q1[S];
  int p0[S], p1[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int a = s == 0 ? 0 : (s == 1 ? a1 : a2);
    const bool need = (get4(idx, a) & MSB) != 0;
    if (need) idx ^= all_fields((1 << IB) - 1) & nibble_mask(subset_of<S>(bits, s));
    q0[s] = need ? st.s[s].q1 : st.s[s].q0;
    q1[s] = need ? st.s[s].q0 : st.s[s].q1;
    p0[s] = need ? st.s[s].p1 : st.s[s].p0;
    p1[s] = need ? st.s[s].p0 : st.s[s].p1;
  }
  Bits128 b = {0ull, 0ull};
  put(b, 1 << M, 0, M + 1);
  int pos = M + 1;
  if (T::PART) {
    put(b, st.pid, pos, T::PART);
    pos += T::PART;
  }
#pragma unroll
  for (int c = 0; c < (AB ? 4 : 3); ++c) {
    const int nb = c < 3 ? CB : AB;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      put(b, getq(q0[s], c), pos, nb);
      put(b, getq(q1[s], c), pos + nb, nb);
      pos += 2 * nb;
    }
  }
  if (PB != 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      put(b, p0[s], pos++, 1);
      if (PB == 2) put(b, p1[s], pos++, 1);
    }
  }
  // pixel 0 and each subset's anchor pixel store one index bit fewer
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int nb = IB - (p == 0 ? 1 : 0) - (S >= 2 && p == a1 ? 1 : 0) - (S == 3 && p == a2 ? 1 : 0);
    put(b, get4(idx, p), pos, nb);
    pos += nb;
  }
  return b;
}

// --------------------------------------------------------- dual-index modes ---
struct DState {
  float err, cerr, aerr;
  int rot, sel;
  uint32_t qc0, qc1;  // colour codes per channel
  int qa0, qa1;       // scalar codes
  u64 cidx, aidx;
};

// rotation r swaps channel r - 1 with alpha; applying it twice undoes it
__device__ __forceinline__ void rotate(float (&xs)[4][16], int rot) {
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const float a = xs[3][p];
    if (rot == 1) {
      xs[3][p] = xs[0][p];
      xs[0][p] = a;
    } else if (rot == 2) {
      xs[3][p] = xs[1][p];
      xs[1][p] = a;
    } else if (rot == 3) {
      xs[3][p] = xs[2][p];
      xs[2][p] = a;
    }
  }
}

// least-squares scalar endpoints for fixed levels; (f0, f1) where singular
__device__ __forceinline__ void lsq_scalar(const float (&v)[16], const float (&a)[16], float f0,
                                           float f1, float& e0, float& e1) {
  float q00 = 0.0f, q01 = 0.0f, q11 = 0.0f, b0 = 0.0f, b1 = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const float one_a = 1.0f - a[p];
    q00 = q00 + one_a * one_a;
    q01 = q01 + one_a * a[p];
    q11 = q11 + a[p] * a[p];
    b0 = b0 + one_a * v[p];
    b1 = b1 + a[p] * v[p];
  }
  const float det = q00 * q11 - q01 * q01;
  const bool ok = fabsf(det) > 1e-6f;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float n0 = (q11 * b0 - q01 * b1) * inv;
  const float n1 = (q00 * b1 - q01 * b0) * inv;
  e0 = ok ? n0 : f0;
  e1 = ok ? n1 : f1;
}

// each pixel's nearest entry of the decoded scalar palette (first of equals)
template <int IB>
__device__ __forceinline__ void nearest_scalar(const float (&v)[16], int d0, int d1, u64& idx,
                                               float& err) {
  idx = 0;
  err = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    float bd = 0.0f;
    int bi = 0;
#pragma unroll
    for (int k = 0; k < (1 << IB); ++k) {
      const float dd = v[p] - (float)lerp64(d0, d1, weight<IB>(k));
      const float d = dd * dd;
      if (k == 0 || d < bd) {
        bd = d;
        bi = k;
      }
    }
    idx |= (u64)bi << (4 * p);
    err = err + bd;
  }
}

// the rotated channel's scalar fit: min/max, `iters` least-squares rounds
// against the nearest level, quantised, nearest entries
template <int BITS, int IB>
__device__ __forceinline__ void fit_scalar(const float (&v)[16], int iters, float& err, int& q0,
                                           int& q1, u64& idx) {
  float e0 = v[0], e1 = v[0];
#pragma unroll
  for (int p = 1; p < 16; ++p) {
    e0 = fminf(e0, v[p]);
    e1 = fmaxf(e1, v[p]);
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const float span = e1 - e0;
    float a[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      float bd = 0.0f;
      a[p] = 0.0f;
#pragma unroll
      for (int k = 0; k < (1 << IB); ++k) {
        const float l = level<IB>(k);
        const float dd = v[p] - (e0 + l * span);
        const float d = dd * dd;
        if (k == 0 || d < bd) {
          bd = d;
          a[p] = l;
        }
      }
    }
    lsq_scalar(v, a, e0, e1, e0, e1);
  }
  int d0, d1;
  quant_plain<BITS>(e0, q0, d0);
  quant_plain<BITS>(e1, q1, d1);
  nearest_scalar<IB>(v, d0, d1, idx, err);
}

// uber selector rounds on the scalar channel; the least-squares fallback is
// (0, 255)
template <int BITS, int IB>
__device__ __forceinline__ void uber_scalar(const float (&v)[16], int uber, float& err, int& q0,
                                            int& q1, u64& idx) {
  int q;
  const int nvar = variant_slots(uber, q);
  const u64 base = idx;
  int mn, mx;
  index_extremes(base, 0xFFFFu, mn, mx);
#pragma unroll 1
  for (int vv = 0; vv < nvar; ++vv) {
    u64 src;
    if (!selector_variant(base, 0xFFFFu, vv, q, (1 << IB) - 1, mn, mx, src)) continue;
    float a[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) a[p] = level<IB>(get4(src, p));
    float e0, e1;
    lsq_scalar(v, a, 0.0f, 255.0f, e0, e1);
    int c0, c1, d0, d1;
    quant_plain<BITS>(e0, c0, d0);
    quant_plain<BITS>(e1, c1, d1);
    u64 ci;
    float ce;
    nearest_scalar<IB>(v, d0, d1, ci, ce);
    if (ce < err) {
      err = ce;
      q0 = c0;
      q1 = c1;
      idx = ci;
    }
  }
}

// one (rotation, index selection) candidate on the rotated block: colour with
// CIB-bit indices, the rotated channel with AIB-bit indices
template <int M, int CIB, int AIB>
__device__ __forceinline__ void dual_candidate(const float (&xs)[4][16], int iters, DState& c) {
  using T = Mode<M>;
  float e0[3], e1[3];
  fit_line<3, CIB>(xs, 0xFFFFu, false, iters, e0, e1);
  Sub cs;
  quant_subset<3, T::CB, 0, CIB>(xs, 0xFFFFu, e0, e1, 1, cs, c.cidx);
  c.cerr = cs.err;
  c.qc0 = cs.q0;
  c.qc1 = cs.q1;
  fit_scalar<T::AB, AIB>(xs[3], iters, c.aerr, c.qa0, c.qa1, c.aidx);
  c.err = c.cerr + c.aerr;
}

// uber (at most level 2) and shake (steps of 1) on both channel groups of a
// candidate; taken where the sum improves
template <int M, int CIB, int AIB>
__device__ __forceinline__ void dual_refine(const float (&xs)[4][16], int shake, int uber,
                                            DState& st) {
  using T = Mode<M>;
  Sub cs = {st.cerr, st.qc0, st.qc1, 0, 0};
  u64 cidx = st.cidx, aidx = st.aidx;
  float aerr = st.aerr;
  int qa0 = st.qa0, qa1 = st.qa1;
  if (uber) {
    const int u2 = uber < 2 ? uber : 2;
    uber_subset<3, T::CB, 0, CIB>(xs, 0xFFFFu, u2, 1, cs, cidx);
    uber_scalar<T::AB, AIB>(xs[3], u2, aerr, qa0, qa1, aidx);
  }
  if (shake) {
    shake_subset<3, 0, T::CB, 0, CIB>(xs, 0xFFFFu, shake, 1, cs, cidx);
    Sub as = {aerr, (uint32_t)qa0, (uint32_t)qa1, 0, 0};
    shake_subset<1, 3, T::AB, 0, AIB>(xs, 0xFFFFu, shake, 1, as, aidx);
    aerr = as.err;
    qa0 = getq(as.q0, 0);
    qa1 = getq(as.q1, 0);
  }
  if (cs.err + aerr < st.err) {
    st.cerr = cs.err;
    st.aerr = aerr;
    st.qc0 = cs.q0;
    st.qc1 = cs.q1;
    st.qa0 = qa0;
    st.qa1 = qa1;
    st.cidx = cidx;
    st.aidx = aidx;
  }
  st.err = st.cerr + st.aerr;
}

// Modes 4/5: 4 rotations x the index selections, the best (and with keep 2
// the runner-up) refined; a refined candidate is refined only on its own
// index selection, which is all the plain version ever takes from it.
template <int M>
__device__ __forceinline__ void dual_mode(float (&xs)[4][16], int iters, int shake, int uber,
                                          int keep, DState& best) {
  using T = Mode<M>;
  const bool keep2 = keep > 1 && (uber || shake);
  DState best2;
#pragma unroll 1
  for (int rot = 0; rot < 4; ++rot) {
    rotate(xs, rot);
#pragma unroll 1
    for (int sel = 0; sel < T::NSEL; ++sel) {
      DState c;
      c.rot = rot;
      c.sel = sel;
      if (T::NSEL == 1 || sel == 0)
        dual_candidate<M, T::IB, T::IB2>(xs, iters, c);
      else
        dual_candidate<M, T::IB2, T::IB>(xs, iters, c);
      const int k = rot * T::NSEL + sel;
      if (k == 0) {
        best = c;
      } else if (keep2) {
        const bool take = c.err < best.err;
        const DState loser = take ? best : c;
        if (take) best = c;
        if (k == 1 || loser.err < best2.err) best2 = loser;
      } else if (c.err < best.err) {
        best = c;
      }
    }
    rotate(xs, rot);
  }
  if (!(uber || shake)) return;
#pragma unroll 1
  for (int r = 0; r < (keep2 ? 2 : 1); ++r) {
    DState st = r ? best2 : best;
    rotate(xs, st.rot);
    if (T::NSEL == 1 || st.sel == 0)
      dual_refine<M, T::IB, T::IB2>(xs, shake, uber, st);
    else
      dual_refine<M, T::IB2, T::IB>(xs, shake, uber, st);
    rotate(xs, st.rot);
    if (r == 0 || st.err < best.err) best = st;
  }
}

// Field 1 (IB bits) drives colour iff sel == 0; each field's anchor fix-up
// complements its indices and swaps the endpoint pair it drives.
template <int M>
__device__ __forceinline__ Bits128 pack_dual(const DState& st) {
  using T = Mode<M>;
  constexpr int IB = T::IB, IB2 = T::IB2, CB = T::CB, AB = T::AB;
  const bool sel0 = st.sel == 0;
  u64 f1 = sel0 ? st.cidx : st.aidx, f2 = sel0 ? st.aidx : st.cidx;
  uint32_t qc0 = st.qc0, qc1 = st.qc1;
  int qa0 = st.qa0, qa1 = st.qa1;
  const bool n1 = (get4(f1, 0) & (1 << (IB - 1))) != 0;
  if (n1) f1 ^= all_fields((1 << IB) - 1);
  const bool n2 = (get4(f2, 0) & (1 << (IB2 - 1))) != 0;
  if (n2) f2 ^= all_fields((1 << IB2) - 1);
  // field 1 swaps colour when sel == 0, field 2 when sel == 1: an odd number
  // of swaps of a pair leaves it swapped
  const bool swc = (n1 && sel0) != (n2 && !sel0);
  const bool swa = (n1 && !sel0) != (n2 && sel0);
  if (swc) {
    const uint32_t t = qc0;
    qc0 = qc1;
    qc1 = t;
  }
  if (swa) {
    const int t = qa0;
    qa0 = qa1;
    qa1 = t;
  }
  Bits128 b = {0ull, 0ull};
  put(b, 1 << M, 0, M + 1);
  int pos = M + 1;
  put(b, st.rot, pos, 2);
  pos += 2;
  if (T::NSEL > 1) put(b, st.sel, pos++, 1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    put(b, getq(qc0, c), pos, CB);
    put(b, getq(qc1, c), pos + CB, CB);
    pos += 2 * CB;
  }
  put(b, qa0, pos, AB);
  put(b, qa1, pos + AB, AB);
  pos += 2 * AB;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int nb = IB - (p == 0 ? 1 : 0);
    put(b, get4(f1, p), pos, nb);
    pos += nb;
  }
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int nb = IB2 - (p == 0 ? 1 : 0);
    put(b, get4(f2, p), pos, nb);
    pos += nb;
  }
  return b;
}

// ---- one block, one mode. xs: the block scaled to 0..255 (the dual modes
// rotate it and restore it). Modes 0-3 add the alpha channel's distance to
// 255, left to right over the pixels.
template <int M>
__device__ __forceinline__ void full_mode(float (&xs)[4][16], const int* ids, int nids, int iters,
                                          int shake, int uber, int keep, Bits128& out, float& err) {
  using T = Mode<M>;
  if constexpr (M == 4 || M == 5) {
    DState st;
    dual_mode<M>(xs, iters, shake, uber, keep, st);
    out = pack_dual<M>(st);
    err = st.err;
  } else {
    StateS<T::S> st;
    single_mode<M>(xs, ids, nids, iters, shake, uber, st);
    out = pack_single<M>(st);
    err = st.err;
    if (T::AB == 0) {
      float pen = 0.0f;
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const float d = xs[3][p] - 255.0f;
        pen = pen + d * d;
      }
      err = err + pen;
    }
  }
}

// ---- block i of the kernel of mode M. A barred block (bar[i] set, modes
// 6/7 only) returns at once: with `merge` its running best stays, without it
// the outputs are words 0 and error 3.4e38. That is the output of running the
// mode and masking its error: the caller passes `bar` only when some mode 0-5
// is enabled, those modes run first (mode order), and their error is finite,
// so a masked error never wins the strict compare of the merge.
template <int M>
__device__ __forceinline__ void full_block(const float* __restrict__ x, int64_t i,
                                           const int* __restrict__ ids, int nids, int iters,
                                           int shake, int uber, int keep,
                                           const uint8_t* __restrict__ bar, int merge,
                                           uint4* __restrict__ words, float* __restrict__ err) {
  if ((M == 6 || M == 7) && bar != nullptr && bar[i]) {
    if (!merge) {
      words[i] = make_uint4(0u, 0u, 0u, 0u);
      err[i] = BIG;
    }
    return;
  }
  float xs[4][16];
  bcx::load_block<4>(x + i * 64, 4, xs);
  Bits128 out;
  float e;
  full_mode<M>(xs, ids ? ids + i * nids : nullptr, nids, iters, shake, uber, keep, out, e);
  if (merge && !(e < err[i])) return;
  words[i] = make_uint4((uint32_t)out.lo, (uint32_t)(out.lo >> 32), (uint32_t)out.hi,
                        (uint32_t)(out.hi >> 32));
  err[i] = e;
}

#ifdef __CUDACC__
// The kernel and its launcher; the host build of this header for the tests
// stops before them.
template <int M>
__global__ void __launch_bounds__(bcx::THREADS)
bc7_full_kernel(const float* __restrict__ x, int64_t n, const int* __restrict__ ids, int nids,
                int iters, int shake, int uber, int keep, const uint8_t* __restrict__ bar,
                int merge, uint4* __restrict__ words, float* __restrict__ err) {
  const int64_t i = bcx::block_index();
  if (i < n) full_block<M>(x, i, ids, nids, iters, shake, uber, keep, bar, merge, words, err);
}

// Launches mode M's kernel on `stream`; returns cudaGetLastError().
template <int M>
inline int launch_full(const float* x, long long n, const int* ids, int nids, int iters, int shake,
                       int uber, int keep, const uint8_t* bar, int merge, uint32_t* words,
                       float* err, void* stream) {
  if (int rc = bcx::check_args(x, 4)) return rc;
  if (Mode<M>::S > 1 && (nids < 1 || nids > 64)) return (int)cudaErrorInvalidValue;
  if (iters < 0 || shake < 0 || uber < 0 || keep < 1 || keep > 2) return (int)cudaErrorInvalidValue;
  bc7_full_kernel<M><<<bcx::grid_for(n), bcx::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, ids, nids, iters, shake, uber, keep, bar, merge, reinterpret_cast<uint4*>(words), err);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace bc7
