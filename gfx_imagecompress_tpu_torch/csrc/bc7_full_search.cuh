// Full BC7 search (K5): one mode of the AMD-path search per block, the search
// of kernels/bc7_full.py. Replaces the Pallas kernel of the JAX package,
// gfx_imagecompress_tpu/kernels/bc7_full_pallas.py:_mode_kernel (body at
// :1015, launched at :1178).
//
// What bounds it: operations. A block is 256 bytes in, 4*K bytes of ids in and
// 20 bytes out against 10^5-10^6 float operations per mode at the top tier:
// per shortlisted partition and subset a PCA fit and a p-bit race with exact
// palette assigns, then on the winner (and the runner-up, "keep-2") up to 38
// uber variants per subset, each refit and requantised, and 3 rounds of a
// 25-step shake cube per channel with a p-bit re-race.
//
// What the design does about it: a group of lanes encodes one block (Shape:
// 16 in mode 0, 8 in the other single-index modes, 4 in the dual modes; one
// in the single-index modes for a budget without refinement); a CTA holds
// several groups. The group loads its block once (float4 loads side by side)
// into shared memory, scaled to 0..255, and every lane reads pixels from
// there; nothing keeps the 64 pixel floats in registers (45-72 registers in
// the fourteen instantiations, no spill stores, as ptxas -v reports them).
// The search is a sequence of phases, and each phase deals independent
// candidates to the lanes:
//   a. one item per partition (dual modes: per rotation and selection), its
//      subsets fitted and quantised in order;
//   b. best and runner-up over those, in their order;
//   c. uber, one item per (group, variant); a group is a chain's subset
//      (dual modes: a chain's colour or scalar channel);
//   d. per shake round, one item per (group, channel, K steps), one scan per
//      (group, channel), one item per (group, p-bit combination) for the
//      re-race on the shaken codes, one scan per group;
//   e. the chain pick, the pack and the merge.
// A lane computes its candidate whole with the plain version's arithmetic and
// writes (error, state) to a slot in shared memory; after the group's barrier
// the winner is picked by a scan of the slots in the sequential order, with the
// sequential loops' compares (scan_min, keep2_step). No sum is reordered and no
// error goes through a shuffle tree, so the words stay those of the plain
// version. Phases with an unbounded number of candidates (partitions, uber
// variants) run in chunks of slots, the scan carrying its incumbent from one
// chunk to the next.
// Why the groups are independent: an uber or shake step of a chain's subset s
// reads and writes only subset s's codes and index fields, and within a shake
// round channel c's steps read and write only channel c's codes at the
// round's fixed indices and p-bits; only the re-race after them changes the
// p-bits and the indices.
// Masked passes (fit_sub, refit_sub, assign_sub, sel_variant: bc7_group.cuh,
// shared with the fast search) visit the set bits of the subset's mask in
// ascending pixel order, so a 3-subset pass costs its subset's pixels, not 16
// predicated slots; a shake item's K steps share one pass over the pixels and
// the round's weights (kept per pixel, written by the re-race's exact assign).
// Items are dealt so that neighbouring lanes work on the same group (same
// trip counts) and, in the dual modes, the same code path.
//
// The route is CUDA C++: integer bit-fields, data-dependent loops and
// per-lane branching. Tensor cores (wgmma) and TMA are not used: the arithmetic
// is scalar float32 with a fixed order of summation, which no matrix unit
// keeps, and a block reads only 256 bytes.
//
// A phase is written as a function of the lane over the group's shared
// struct, handed to `run`: the kernel's runner (GroupRun, bc7_group.cuh) runs
// it on each lane and then the group's barrier (__syncwarp on the group's
// lanes); the host build of the tests runs it as a loop over the lanes. Control flow between phases depends
// only on launch arguments and on shared values read after a barrier, so it is
// the same on every lane.
//
// Bit-agreement with the plain version: candidates in its order, strict <
// (first wins), sums over pixels left to right in pixel order, Python-double
// constants rounded once to float, rintf for half-to-even, no multiply-add
// contraction (build flag).
#pragma once
#include "bc7_group.cuh"

namespace bc7 {

constexpr int MAX_STEPS = 25;             // shake steps at srange 2

// Launch shape of mode M: the lanes of a block match the candidates of its
// phases. Mode 0 fits 16 partitions: 16 lanes. The other single-index modes
// fit 8 partitions (or one): 8 lanes. The dual modes have 4 or 8 (rotation,
// selection) candidates on two index widths: 4 lanes, so that the lanes of a
// step share a code path. Measured on the H100 against 8, 16 and 32 lanes
// (single-index modes) and 2, 4 and 8 (dual modes): PERF.md.
// W = 1 is the narrow shape of the single-index modes, for budgets without
// refinement (no uber, no shake: quality 0.25 and below), where the only
// candidates are the shortlisted partitions (one at quality 0.25): one lane
// per block, 64 blocks per CTA, on a shared struct without the refinement's
// areas. The dual modes keep their shape (their candidates fill the lanes).
template <int M, int W = 0>
struct Shape {
  enum {
    DUAL = M == 4 || M == 5,
    LANES = W && !DUAL ? 1 : (M == 0 ? 16 : (DUAL ? 4 : 8)),  // lanes per BC7 block
    THREADS = LANES == 16 ? 128 : 64,      // threads per CTA
    BLOCKS = THREADS / LANES,              // BC7 blocks per CTA
    MIN_CTAS = 512 / THREADS,              // CTAs per SM: at most 128 registers
    SLOTS = DUAL ? 4 * LANES : 3 * LANES,  // candidate slots of a chunked phase
  };
};

// The shape of mode M's launch for a budget: the narrow one for a
// single-index mode without refinement.
template <int M>
inline bool narrow_shape(int shake, int uber) {
  return !Shape<M>::DUAL && shake == 0 && uber == 0;
}

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

// ---- the keep-2 scan (the strict-< scan, scan_min, is bc7_group.cuh's)

// One step of the keep-2 scan: candidate error `ce` against the best `be`
// and the runner-up `b2e` (`have2`: there is one). Bit 0: the candidate
// becomes the best; bit 1: the runner-up becomes the one of the two that is
// not the best now (the demoted best if bit 0, else the candidate). A demoted
// best replaces the runner-up only on a strict <, so with errors 5, 5, 3 the
// runner-up is candidate 1, not candidate 0.
__device__ __forceinline__ int keep2_step(float ce, float be, float b2e, bool have2) {
  const bool take = ce < be;
  const float le = take ? be : ce;
  return (take ? 1 : 0) | ((!have2 || le < b2e) ? 2 : 0);
}

// Quantise one subset's float endpoints against the exact palette. Without
// p-bits: plain codes, one assign. With p-bits: the combinations raced by the
// endpoints' rounding error, the winner assigned exactly - and with race 2 the
// best loser too, the smaller error winning (first on a tie).
template <int NC, int CB, int PB, int IB, bool FULL, class X>
__device__ __forceinline__ void quant_subset(const X& xs, uint32_t mask,
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
    assign_sub<NC, 0, IB, FULL>(xs, d0, d1, mask, idx, out.err);
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
      assign_sub<NC, 0, IB, FULL>(xs, d0, d1, mask, ci, c.err);
      if (r == 0 || c.err < out.err) {
        out = c;
        idx = ci;
      }
    }
  }
}

// ---- shared state of a group
struct Rerace {    // one p-bit combination of a group's re-race
  float err;
  u64 idx;
  uint8_t w[16];   // the weights its indices select, per pixel
};

// uber item v of a group: selector variant v of the entry's indices, refit
// by least squares (falling back to the entry's decoded endpoints) and
// requantised; ok = 0 for the identity variant, which is skipped
template <int NC, int CB, int PB, int IB, bool FULL>
__device__ __forceinline__ void uber_item(const float (&xs)[4][16], const Entry& e, int v, int q,
                                          int race, Slot& out) {
  u64 src;
  out.ok = sel_variant<FULL>(e.base, e.mask, v, q, (1 << IB) - 1, e.mn, e.mx, src) ? 1 : 0;
  if (!out.ok) return;
  float e0[NC], e1[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    e0[c] = (float)deq_ch<CB, PB>(getq(e.s.q0, c), e.s.p0);
    e1[c] = (float)deq_ch<CB, PB>(getq(e.s.q1, c), e.s.p1);
  }
  refit_sub<NC, IB, FULL>(xs, src, e.mask, e0, e1);
  quant_subset<NC, CB, PB, IB, FULL>(xs, e.mask, e0, e1, race, out.s, out.idx);
}

// the endpoint step (da, db) of shake step j at range SR: j = 0 is the start
// (0, 0), the others walk [-SR, SR]^2 row by row, the centre left out
template <int SR>
__device__ __forceinline__ void shake_step(int j, int& da, int& db) {
  constexpr int SIDE = 2 * SR + 1, CENTRE = SIDE * SIDE / 2;
  da = db = 0;
  if (j > 0) {
    const int k = (j - 1) + ((j - 1) >= CENTRE ? 1 : 0);
    da = k / SIDE - SR;
    db = k % SIDE - SR;
  }
}

// channel c's codes of st moved by shake step j
template <int BITS, int SR>
__device__ __forceinline__ void shake_codes(const Sub& st, int c, int j, int& q0, int& q1) {
  constexpr int MAXQ = (1 << BITS) - 1;
  int da, db;
  shake_step<SR>(j, da, db);
  q0 = bcx::clamp_i(getq(st.q0, c) + da, 0, MAXQ);
  q1 = bcx::clamp_i(getq(st.q1, c) + db, 0, MAXQ);
}

// shake item: channel c of st stepped by steps j0..j0+K-1, each step's error
// over the pixels of the mask at the round's weights (w, per pixel), into
// se[0..K). x: the channel's pixel row. Each error is its own sum over the
// pixels in ascending order; the K steps share the pixel and weight reads.
template <int BITS, int PB, int SR, int K, bool FULL>
__device__ __forceinline__ void shake_item(const float* x, const uint8_t* w, uint32_t mask,
                                           const Sub& st, int c, int j0, float* se) {
  int d0[K], d1[K];
  float e[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    int q0, q1;
    shake_codes<BITS, SR>(st, c, j0 + i, q0, q1);
    d0[i] = deq_ch<BITS, PB>(q0, st.p0);
    d1[i] = deq_ch<BITS, PB>(q1, st.p1);
    e[i] = 0.0f;
  }
  for_pixels<FULL>(mask, [&](int p) {
    const int wk = w[p];
    const float xv = x[p];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float diff = (float)lerp64(d0[i], d1[i], wk) - xv;
      e[i] = e[i] + 1.0f * diff * diff;
    }
  });
#pragma unroll
  for (int i = 0; i < K; ++i) se[i] = e[i];
}

// The shake scan of one channel: the start (step 0) first, strict < after.
// Returns the winning step.
template <int SR>
__device__ __forceinline__ int shake_pick(const float* se) {
  constexpr int STEPS = (2 * SR + 1) * (2 * SR + 1);
  float be = se[0];
  return 1 + scan_min(be, STEPS - 1, [&](int t) { return se[1 + t]; });
}

// st with each channel's codes moved by its winning step bj[c]
template <int NC, int BITS, int SR>
__device__ __forceinline__ Sub shaken(const Sub& st, const uint8_t* bj) {
  Sub n = st;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    int q0, q1;
    shake_codes<BITS, SR>(st, c, bj[c], q0, q1);
    setq(n.q0, c, q0);
    setq(n.q1, c, q1);
  }
  return n;
}

// re-race item: combination cb's p-bits on the shaken codes, assigned
// exactly; PB == 0 keeps the subset's p-bits (0)
template <int NC, int C0, int BITS, int PB, int IB, bool FULL, class X>
__device__ __forceinline__ void rerace_item(const X& xs, const Sub& st,
                                            uint32_t mask, int cb, Rerace& out) {
  const int np0 = PB == 0 ? st.p0 : combo_p0<PB>(cb);
  const int np1 = PB == 0 ? st.p1 : combo_p1<PB>(cb);
  int d0[NC], d1[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    d0[c] = deq_ch<BITS, PB>(getq(st.q0, c), np0);
    d1[c] = deq_ch<BITS, PB>(getq(st.q1, c), np1);
  }
  assign_sub<NC, C0, IB, FULL>(xs, d0, d1, mask, out.idx, out.err, out.w);
}

// The re-race scan of a group: combination 0 first, strict < after; the
// winner's p-bits, error, indices and weights become the group's.
template <int PB>
__device__ __forceinline__ void rerace_pick(const Rerace* rr, int ncb, Sub& st, u64& idx,
                                            uint8_t* w) {
  float be = rr[0].err;
  const int cb = 1 + scan_min(be, ncb - 1, [&](int t) { return rr[1 + t].err; });
  st.err = be;
  st.p0 = PB == 0 ? st.p0 : combo_p0<PB>(cb);
  st.p1 = PB == 0 ? st.p1 : combo_p1<PB>(cb);
  idx = rr[cb].idx;
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = rr[cb].w[k];
}

// a group's weights at its indices, per pixel of the mask
template <int IB>
__device__ __forceinline__ void group_weights(u64 idx, uint32_t mask, uint8_t* w) {
  for_pixels<false>(mask, [&](int p) { w[p] = (uint8_t)weight<IB>(get4(idx, p)); });
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

template <int M>
struct SharedS {
  enum { S = Mode<M>::S, NC = Mode<M>::NC, NG = 2 * S, NCB = Combos<Mode<M>::PB>::N };
  enum { L = Shape<M>::LANES, SLOTS = Shape<M>::SLOTS };
  float xs[4][16];        // the block scaled to 0..255
  Chain<S> ch[2];         // best and runner-up; after the search ch[0] wins
  Entry ent[NG];          // refinement groups: chain r, subset s at r * S + s
  int have2;
  uint8_t w[NG][16];      // a group's weights at the shake round's indices
  uint8_t bj[NG][NC];     // a shake round's winning step per channel
  union {
    Chain<S> part[L];     // a chunk of partitions
    Slot slot[SLOTS];     // a chunk of uber items
    float se[NG * NC * MAX_STEPS];
    Rerace rr[NG * NCB];
  } u;
};

// The narrow shape's struct (Shape<M, 1>): one lane, no refinement, so no
// refinement groups, weights or slots.
template <int M>
struct SharedN {
  enum { S = Mode<M>::S };
  float xs[4][16];
  Chain<S> ch[2];
  int have2;
  union {
    Chain<S> part[1];
  } u;
};

// The shake of the single-index modes, SR its step range: per round one item
// per (group, channel, K steps), a scan per (group, channel), one item per
// (group, p-bit combination) on the shaken codes, a scan per group.
template <int M, int SR, class Run>
__device__ __forceinline__ void single_shake(SharedS<M>& sh, int ng, int rounds, Run&& run) {
  using T = Mode<M>;
  constexpr int S = T::S, NC = T::NC, CB = T::CB, PB = T::PB, IB = T::IB;
  constexpr int NCB = Combos<PB>::N, L = Shape<M>::LANES;
  constexpr int STEPS = (2 * SR + 1) * (2 * SR + 1), K = 2 * SR + 1, NB = STEPS / K;
  constexpr bool FULL = S == 1;
#pragma unroll 1
  for (int rd = 0; rd < rounds; ++rd) {
    run([&](int lane) {
#pragma unroll 1
      for (int t = lane; t < ng * NC * NB; t += L) {
        const int gc = t / NB, g = gc / NC, c = gc % NC, j0 = (t % NB) * K;
        shake_item<CB, PB, SR, K, FULL>(sh.xs[c], sh.w[g], sh.ent[g].mask, sh.ch[g / S].s[g % S], c,
                                        j0, sh.u.se + gc * STEPS + j0);
      }
    });
    run([&](int lane) {
#pragma unroll 1
      for (int gc = lane; gc < ng * NC; gc += L)
        sh.bj[gc / NC][gc % NC] = (uint8_t)shake_pick<SR>(sh.u.se + gc * STEPS);
    });
    run([&](int lane) {
#pragma unroll 1
      for (int t = lane; t < ng * NCB; t += L) {
        const int g = t / NCB;
        const Sub st = shaken<NC, CB, SR>(sh.ch[g / S].s[g % S], sh.bj[g]);
        rerace_item<NC, 0, CB, PB, IB, FULL>(sh.xs, st, sh.ent[g].mask, t % NCB, sh.u.rr[t]);
      }
    });
    run([&](int lane) {
#pragma unroll 1
      for (int g = lane; g < ng; g += L) {
        Sub& st = sh.ch[g / S].s[g % S];
        st = shaken<NC, CB, SR>(st, sh.bj[g]);
        rerace_pick<PB>(sh.u.rr + g * NCB, NCB, st, sh.ch[g / S].idx[g % S], sh.w[g]);
      }
    });
  }
}

// Phases c-e of a single-index mode on the best partition (and with keep-2
// the runner-up): uber, shake, the chain pick.
template <int M, class Run>
__device__ __forceinline__ void single_refine(SharedS<M>& sh, bool keep2, int race, int shake,
                                              int uber, Run&& run) {
  using T = Mode<M>;
  constexpr int S = T::S, NC = T::NC, CB = T::CB, PB = T::PB, IB = T::IB;
  constexpr int L = Shape<M>::LANES, SLOTS = Shape<M>::SLOTS;
  constexpr bool FULL = S == 1;

  // the refinement: group g = r * S + s, chain r (0 best, 1 runner-up)
  const int nch = keep2 ? 2 : 1, ng = nch * S;
  run([&](int lane) {
#pragma unroll 1
    for (int g = lane; g < ng; g += L) {
      const int r = g / S, s = g % S;
      Entry& e = sh.ent[g];
      e.s = sh.ch[r].s[s];
      e.base = sh.ch[r].idx[s];
      e.mask = subset_of<S>(shape_bits<S>(sh.ch[r].pid), s);
      index_extremes(e.base, e.mask, e.mn, e.mx);
    }
  });

  // c: uber, one item per (group, variant), the variants of a group side by
  // side, in chunks; per group the entry first, then the variants in order
  if (uber) {
    int q;
    const int nvar = variant_slots(uber, q), total = nvar * ng;
#pragma unroll 1
    for (int t0 = 0; t0 < total; t0 += SLOTS) {
      const int nt = min(SLOTS, total - t0);
      run([&](int lane) {
        if (lane >= nt) return;
        int g = (t0 + lane) / nvar, v = (t0 + lane) % nvar;
#pragma unroll 1
        for (int t = lane; t < nt; t += L) {
          uber_item<NC, CB, PB, IB, FULL>(sh.xs, sh.ent[g], v, q, race, sh.u.slot[t]);
          for (v += L; v >= nvar; v -= nvar) ++g;
        }
      });
      run([&](int lane) {
#pragma unroll 1
        for (int g = lane; g < ng; g += L)
          uber_pick(sh.u.slot, t0, nt, g, nvar, sh.ch[g / S].s[g % S], sh.ch[g / S].idx[g % S]);
      });
    }
  }

  // d: the shake, round by round, from the weights of the indices it starts
  // from
  if (shake) {
    run([&](int lane) {
#pragma unroll 1
      for (int g = lane; g < ng; g += L)
        group_weights<IB>(sh.ch[g / S].idx[g % S], sh.ent[g].mask, sh.w[g]);
    });
    if (shake >= 3)
      single_shake<M, 2>(sh, ng, shake, run);
    else
      single_shake<M, 1>(sh, ng, shake, run);
  }

  // e: each chain's error over its subsets in order; the first chain, then
  // the runner-up's on a strict <
  run([&](int lane) {
    if (lane != 0) return;
    float errs[2];
#pragma unroll 1
    for (int r = 0; r < nch; ++r) {
      float e = 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) e = e + sh.ch[r].s[s].err;
      errs[r] = sh.ch[r].err = e;
    }
    float be = errs[0];
    if (scan_min(be, nch - 1, [&](int t) { return errs[1 + t]; }) == 0)
      sh.ch[0] = sh.ch[1];
  });
}

// Modes 0/1/2/3/6/7: every shortlisted partition fitted and quantised per
// subset; the best (and for the 5-bit-or-less multi-subset modes the
// runner-up too) refined per subset by uber rounds and the shake. ids: the
// block's shortlist, or null for partitions 0..nids-1. The result is sh.ch[0].
template <int M, int W, class Sh, class Run>
__device__ __forceinline__ void single_search(Sh& sh, const int* ids, int nids, int iters,
                                              int shake, int uber, Run&& run) {
  using T = Mode<M>;
  constexpr int S = T::S, NC = T::NC, CB = T::CB, PB = T::PB, IB = T::IB;
  constexpr int L = Shape<M, W>::LANES;
  constexpr bool FULL = S == 1;
  const int nparts = S == 1 ? 1 : nids;
  const bool keep2 = CB <= 5 && S >= 2 && nparts > 1 && (uber || shake);
  // mode 0: the best two p-bit combinations raced exactly, two more uber levels
  constexpr bool low4 = CB <= 4 && PB != 0;
  const int race = low4 ? 2 : 1;
  if (low4 && uber) uber += 2;

  // a: one item per partition, its subsets in order, L partitions a chunk;
  // b: the keep-2 scan in partition order over the chunk's errors, the
  // winners copied once at the chunk's end (refs: -1 ch[0], -2 ch[1])
#pragma unroll 1
  for (int k0 = 0; k0 < nparts; k0 += L) {
    const int nk = min(L, nparts - k0);
    run([&](int lane) {
      if (lane >= nk) return;
      Chain<S>& c = sh.u.part[lane];
      c.pid = S == 1 ? 0 : (ids ? ids[k0 + lane] : k0 + lane);
      c.err = 0.0f;
      const uint32_t bits = shape_bits<S>(c.pid);
#pragma unroll 1
      for (int s = 0; s < S; ++s) {
        const uint32_t mask = subset_of<S>(bits, s);
        float e0[NC], e1[NC];
        fit_sub<NC, IB, FULL>(sh.xs, mask, iters, e0, e1);
        quant_subset<NC, CB, PB, IB, FULL>(sh.xs, mask, e0, e1, race, c.s[s], c.idx[s]);
        c.err = c.err + c.s[s].err;
      }
    });
    run([&](int lane) {
      if (lane != 0) return;
      auto err_of = [&](int ref) {
        return ref == -1 ? sh.ch[0].err : (ref == -2 ? sh.ch[1].err : sh.u.part[ref].err);
      };
      int r0 = -1, r1 = -2;
      bool have2 = sh.have2 != 0;
#pragma unroll 1
      for (int kk = 0; kk < nk; ++kk) {
        const float e = sh.u.part[kk].err;
        if (k0 + kk == 0) {
          r0 = kk;
          have2 = false;
        } else if (keep2) {
          const int a = keep2_step(e, err_of(r0), have2 ? err_of(r1) : 0.0f, have2);
          if (a & 2) {
            r1 = (a & 1) ? r0 : kk;
            have2 = true;
          }
          if (a & 1) r0 = kk;
        } else if (e < err_of(r0)) {
          r0 = kk;
        }
      }
      if (r1 == -1)
        sh.ch[1] = sh.ch[0];
      else if (r1 >= 0)
        sh.ch[1] = sh.u.part[r1];
      if (r0 >= 0) sh.ch[0] = sh.u.part[r0];
      sh.have2 = have2 ? 1 : 0;
    });
  }
  if constexpr (W == 0) {
    if (uber || shake) single_refine<M>(sh, keep2, race, shake, uber, run);
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

template <int M>
__device__ __forceinline__ Bits128 pack_chain(const Chain<Mode<M>::S>& c) {
  StateS<Mode<M>::S> st;
  st.err = c.err;
  st.pid = c.pid;
  st.idx = 0;
#pragma unroll
  for (int s = 0; s < Mode<M>::S; ++s) {
    st.s[s] = c.s[s];
    st.idx |= c.idx[s];
  }
  return pack_single<M>(st);
}

// --------------------------------------------------------- dual-index modes ---
// The block's channel rows under rotation rot, read as xs[c][p] like the
// block itself: rotation r swaps channel r - 1 with alpha.
struct Rows {
  const float* r[4];
  __device__ __forceinline__ const float* operator[](int c) const { return r[c]; }
};

__device__ __forceinline__ Rows rotated(const float (&xs)[4][16], int rot) {
  Rows v;
#pragma unroll
  for (int c = 0; c < 4; ++c) v.r[c] = xs[rot > 0 && c == rot - 1 ? 3 : (rot > 0 && c == 3 ? rot - 1 : c)];
  return v;
}

struct DState {
  float err, cerr, aerr;
  int rot, sel;
  uint32_t qc0, qc1;  // colour codes per channel
  int qa0, qa1;       // scalar codes
  u64 cidx, aidx;
};

// least-squares scalar endpoints for the levels a(p); (f0, f1) where singular
template <class A>
__device__ __forceinline__ void lsq_scalar(const float* v, A&& a_of, float f0, float f1,
                                           float& e0, float& e1) {
  float q00 = 0.0f, q01 = 0.0f, q11 = 0.0f, b0 = 0.0f, b1 = 0.0f;
#pragma unroll 1
  for (int p = 0; p < 16; ++p) {
    const float a = a_of(p);
    const float one_a = 1.0f - a;
    q00 = q00 + one_a * one_a;
    q01 = q01 + one_a * a;
    q11 = q11 + a * a;
    b0 = b0 + one_a * v[p];
    b1 = b1 + a * v[p];
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
__device__ __forceinline__ void nearest_scalar(const float* v, int d0, int d1, u64& idx,
                                               float& err) {
  u64 acc = 0;
  float e = 0.0f;
#pragma unroll 1
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
    acc |= (u64)bi << (4 * p);
    e = e + bd;
  }
  idx = acc;
  err = e;
}

// the rotated channel's scalar fit: min/max, `iters` least-squares rounds
// against the nearest level, quantised, nearest entries
template <int BITS, int IB>
__device__ __forceinline__ void fit_scalar(const float* v, int iters, float& err, int& q0,
                                           int& q1, u64& idx) {
  float e0 = v[0], e1 = v[0];
#pragma unroll 1
  for (int p = 1; p < 16; ++p) {
    e0 = fminf(e0, v[p]);
    e1 = fmaxf(e1, v[p]);
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const float span = e1 - e0, lo = e0;
    lsq_scalar(v, [&](int p) {
      float bd = 0.0f, a = 0.0f;
#pragma unroll
      for (int k = 0; k < (1 << IB); ++k) {
        const float l = level<IB>(k);
        const float dd = v[p] - (lo + l * span);
        const float d = dd * dd;
        if (k == 0 || d < bd) {
          bd = d;
          a = l;
        }
      }
      return a;
    }, e0, e1, e0, e1);
  }
  int d0, d1;
  quant_plain<BITS>(e0, q0, d0);
  quant_plain<BITS>(e1, q1, d1);
  nearest_scalar<IB>(v, d0, d1, idx, err);
}

// one (rotation, index selection) candidate on the rotated block: colour with
// CIB-bit indices, the rotated channel with AIB-bit indices
template <int M, int CIB, int AIB>
__device__ __forceinline__ void dual_candidate(const Rows& xs, int iters, DState& c) {
  using T = Mode<M>;
  float e0[3], e1[3];
  fit_sub<3, CIB, true>(xs, 0xFFFFu, iters, e0, e1);
  Sub cs;
  quant_subset<3, T::CB, 0, CIB, true>(xs, 0xFFFFu, e0, e1, 1, cs, c.cidx);
  c.cerr = cs.err;
  c.qc0 = cs.q0;
  c.qc1 = cs.q1;
  fit_scalar<T::AB, AIB>(xs[3], iters, c.aerr, c.qa0, c.qa1, c.aidx);
  c.err = c.cerr + c.aerr;
}

// uber item v of a dual group: kind 0 the colour endpoints (refit, falling
// back to the entry's decoded endpoints), kind 1 the scalar channel (refit,
// falling back to (0, 255)); ok = 0 for the identity variant
template <int M, int CIB, int AIB>
__device__ __forceinline__ void dual_uber_item(const Rows& xs, const Entry& e, int kind,
                                               int v, int q, Slot& out) {
  using T = Mode<M>;
  u64 src;
  out.ok = sel_variant<true>(e.base, 0xFFFFu, v, q, (1 << (kind ? AIB : CIB)) - 1, e.mn, e.mx, src)
               ? 1 : 0;
  if (!out.ok) return;
  if (kind == 0) {
    float e0[3], e1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      e0[c] = (float)deq_ch<T::CB, 0>(getq(e.s.q0, c), 0);
      e1[c] = (float)deq_ch<T::CB, 0>(getq(e.s.q1, c), 0);
    }
    refit_sub<3, CIB, true>(xs, src, 0xFFFFu, e0, e1);
    quant_subset<3, T::CB, 0, CIB, true>(xs, 0xFFFFu, e0, e1, 1, out.s, out.idx);
  } else {
    float e0, e1;
    lsq_scalar(xs[3], [&](int p) { return level<AIB>(get4(src, p)); }, 0.0f, 255.0f, e0, e1);
    int c0, c1, d0, d1;
    quant_plain<T::AB>(e0, c0, d0);
    quant_plain<T::AB>(e1, c1, d1);
    nearest_scalar<AIB>(xs[3], d0, d1, out.idx, out.s.err);
    out.s.q0 = (uint32_t)c0;
    out.s.q1 = (uint32_t)c1;
    out.s.p0 = out.s.p1 = 0;
  }
}

template <int M>
struct SharedD {
  enum { NCAND = 4 * Mode<M>::NSEL, SLOTS = Shape<M>::SLOTS };
  float xs[4][16];     // the block scaled to 0..255
  DState ch[2];        // best and runner-up; after the search ch[0] wins
  Sub gs[4];           // refinement groups: chain r, kind (colour, scalar)
  u64 gi[4];           //   at r * 2 + kind
  Entry ent[4];
  uint8_t w[4][16];    // a group's weights at the shake round's indices
  uint8_t bj[4][3];    // a shake round's winning step per channel
  union {
    DState cand[NCAND];  // (rotation, selection) at rot * NSEL + sel
    Slot slot[SLOTS];
    float se[2 * 4 * 9];
    Rerace rr[4];
  } u;
};

// Modes 4/5: 4 rotations x the index selections, the best (and with keep 2
// the runner-up) refined: uber (at most level 2) and shake (steps of 1) on
// the colour endpoints and on the scalar channel, taken where the sum
// improves. A refined candidate is refined only on its own index selection,
// which is all the plain version ever takes from it. Items are dealt so that
// the lanes of a step share an index selection and a channel group, and so
// run one code path. The result is sh.ch[0].
template <int M, class Run>
__device__ __forceinline__ void dual_search(SharedD<M>& sh, int iters, int shake, int uber,
                                            int keep, Run&& run) {
  using T = Mode<M>;
  constexpr int NSEL = T::NSEL, IB = T::IB, IB2 = T::IB2, L = Shape<M>::LANES;
  constexpr int SLOTS = Shape<M>::SLOTS;
  const bool keep2 = keep > 1 && (uber || shake);
  // a: item t is selection t / 4, rotation t % 4
  run([&](int lane) {
#pragma unroll 1
    for (int t = lane; t < 4 * NSEL; t += L) {
      const int rot = t % 4, sel = t / 4;
      DState& c = sh.u.cand[rot * NSEL + sel];
      c.rot = rot;
      c.sel = sel;
      if (NSEL == 1 || sel == 0)
        dual_candidate<M, IB, IB2>(rotated(sh.xs, rot), iters, c);
      else
        dual_candidate<M, IB2, IB>(rotated(sh.xs, rot), iters, c);
    }
  });
  // b: the keep-2 scan in (rotation, selection) order
  run([&](int lane) {
    if (lane != 0) return;
    sh.ch[0] = sh.u.cand[0];
#pragma unroll 1
    for (int k = 1; k < 4 * NSEL; ++k) {
      const DState& c = sh.u.cand[k];
      if (keep2) {
        const int a = keep2_step(c.err, sh.ch[0].err, sh.ch[1].err, k > 1);
        if (a & 2) sh.ch[1] = (a & 1) ? sh.ch[0] : c;
        if (a & 1) sh.ch[0] = c;
      } else if (c.err < sh.ch[0].err) {
        sh.ch[0] = c;
      }
    }
  });
  if (!(uber || shake)) return;

  const int nch = keep2 ? 2 : 1, ng = 2 * nch;
  run([&](int lane) {
#pragma unroll 1
    for (int g = lane; g < ng; g += L) {
      const DState& st = sh.ch[g / 2];
      Sub& s = sh.gs[g];
      if (g % 2 == 0) {
        s = {st.cerr, st.qc0, st.qc1, 0, 0};
        sh.gi[g] = st.cidx;
      } else {
        s = {st.aerr, (uint32_t)st.qa0, (uint32_t)st.qa1, 0, 0};
        sh.gi[g] = st.aidx;
      }
      Entry& e = sh.ent[g];
      e.s = s;
      e.base = sh.gi[g];
      e.mask = 0xFFFFu;
      index_extremes(e.base, 0xFFFFu, e.mn, e.mx);
    }
  });
  // c: uber, one item per (group, variant), the variants of a group side by
  // side
  if (uber) {
    int q;
    const int nvar = variant_slots(uber < 2 ? uber : 2, q), total = nvar * ng;
#pragma unroll 1
    for (int t0 = 0; t0 < total; t0 += SLOTS) {
      const int nt = min(SLOTS, total - t0);
      run([&](int lane) {
        if (lane >= nt) return;
        int g = (t0 + lane) / nvar, v = (t0 + lane) % nvar;
#pragma unroll 1
        for (int t = lane; t < nt; t += L) {
          const DState& st = sh.ch[g / 2];
          if (NSEL == 1 || st.sel == 0)
            dual_uber_item<M, IB, IB2>(rotated(sh.xs, st.rot), sh.ent[g], g % 2, v, q, sh.u.slot[t]);
          else
            dual_uber_item<M, IB2, IB>(rotated(sh.xs, st.rot), sh.ent[g], g % 2, v, q, sh.u.slot[t]);
          for (v += L; v >= nvar; v -= nvar) ++g;
        }
      });
      run([&](int lane) {
#pragma unroll 1
        for (int g = lane; g < ng; g += L) uber_pick(sh.u.slot, t0, nt, g, nvar, sh.gs[g], sh.gi[g]);
      });
    }
  }
  // d: the shake; per chain 4 channel passes of 9 steps: colour 0-2 (group
  // r * 2), scalar (group r * 2 + 1)
  if (shake) {
    run([&](int lane) {
#pragma unroll 1
      for (int g = lane; g < ng; g += L) {
        const bool s0 = NSEL == 1 || sh.ch[g / 2].sel == 0;
        if (s0 == (g % 2 == 0))
          group_weights<IB>(sh.gi[g], 0xFFFFu, sh.w[g]);
        else
          group_weights<IB2>(sh.gi[g], 0xFFFFu, sh.w[g]);
      }
    });
#pragma unroll 1
    for (int rd = 0; rd < shake; ++rd) {
      run([&](int lane) {
#pragma unroll 1
        for (int t = lane; t < nch * 4 * 3; t += L) {
          const int r = t / 12, cc = (t / 3) % 4, g = 2 * r + (cc == 3 ? 1 : 0), j0 = (t % 3) * 3;
          const Rows xs = rotated(sh.xs, sh.ch[r].rot);
          float* se = sh.u.se + (r * 4 + cc) * 9 + j0;
          if (cc < 3)
            shake_item<T::CB, 0, 1, 3, true>(xs[cc], sh.w[g], 0xFFFFu, sh.gs[g], cc, j0, se);
          else
            shake_item<T::AB, 0, 1, 3, true>(xs[3], sh.w[g], 0xFFFFu, sh.gs[g], 0, j0, se);
        }
      });
      run([&](int lane) {
#pragma unroll 1
        for (int rc = lane; rc < nch * 4; rc += L) {
          const int r = rc / 4, cc = rc % 4;
          sh.bj[2 * r + (cc == 3 ? 1 : 0)][cc == 3 ? 0 : cc] =
              (uint8_t)shake_pick<1>(sh.u.se + rc * 9);
        }
      });
      // the re-race has one combination (no p-bits): the requantise
      run([&](int lane) {
#pragma unroll 1
        for (int g = lane; g < ng; g += L) {
          const DState& st = sh.ch[g / 2];
          const bool s0 = NSEL == 1 || st.sel == 0;
          const Rows xs = rotated(sh.xs, st.rot);
          if (g % 2 == 0) {
            const Sub n = shaken<3, T::CB, 1>(sh.gs[g], sh.bj[g]);
            if (s0)
              rerace_item<3, 0, T::CB, 0, IB, true>(xs, n, 0xFFFFu, 0, sh.u.rr[g]);
            else
              rerace_item<3, 0, T::CB, 0, IB2, true>(xs, n, 0xFFFFu, 0, sh.u.rr[g]);
          } else {
            const Sub n = shaken<1, T::AB, 1>(sh.gs[g], sh.bj[g]);
            if (s0)
              rerace_item<1, 3, T::AB, 0, IB2, true>(xs, n, 0xFFFFu, 0, sh.u.rr[g]);
            else
              rerace_item<1, 3, T::AB, 0, IB, true>(xs, n, 0xFFFFu, 0, sh.u.rr[g]);
          }
        }
      });
      run([&](int lane) {
#pragma unroll 1
        for (int g = lane; g < ng; g += L) {
          Sub& gs = sh.gs[g];
          gs = g % 2 == 0 ? shaken<3, T::CB, 1>(gs, sh.bj[g]) : shaken<1, T::AB, 1>(gs, sh.bj[g]);
          rerace_pick<0>(sh.u.rr + g, 1, gs, sh.gi[g], sh.w[g]);
        }
      });
    }
  }
  // e: each chain takes its refined groups where their sum is strictly
  // smaller; the first chain, then the runner-up's on a strict <
  run([&](int lane) {
    if (lane != 0) return;
    float errs[2];
#pragma unroll 1
    for (int r = 0; r < nch; ++r) {
      DState& st = sh.ch[r];
      const Sub &cs = sh.gs[2 * r], &as = sh.gs[2 * r + 1];
      if (cs.err + as.err < st.err) {
        st.cerr = cs.err;
        st.aerr = as.err;
        st.qc0 = cs.q0;
        st.qc1 = cs.q1;
        st.qa0 = getq(as.q0, 0);
        st.qa1 = getq(as.q1, 0);
        st.cidx = sh.gi[2 * r];
        st.aidx = sh.gi[2 * r + 1];
      }
      errs[r] = st.err = st.cerr + st.aerr;
    }
    float be = errs[0];
    if (scan_min(be, nch - 1, [&](int t) { return errs[1 + t]; }) == 0)
      sh.ch[0] = sh.ch[1];
  });
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

// ---- one block, one mode
template <int M, int W = 0>
struct SharedOf {
  using type = SharedS<M>;
};
template <int M>
struct SharedOf<M, 1> {
  using type = SharedN<M>;
};
template <>
struct SharedOf<4> {
  using type = SharedD<4>;
};
template <>
struct SharedOf<5> {
  using type = SharedD<5>;
};

// Block i of the kernel of mode M, on the group's shared struct. A barred
// block (bar[i] set, modes 6/7 only) returns at once: with `merge` its running
// best stays, without it the outputs are words 0 and error 3.4e38. That is the
// output of running the mode and masking its error: the caller passes `bar`
// only when some mode 0-5 is enabled, those modes run first (mode order), and
// their error is finite, so a masked error never wins the strict compare of the
// merge. Modes 0-3 add the alpha channel's distance to 255, left to right over
// the pixels.
template <int M, int W, class Run>
__device__ __forceinline__ void full_block(typename SharedOf<M, W>::type& sh,
                                           const float* __restrict__ x, int64_t i,
                                           const int* __restrict__ ids, int nids, int iters,
                                           int shake, int uber, int keep,
                                           const uint8_t* __restrict__ bar, int merge,
                                           uint4* __restrict__ words, float* __restrict__ err,
                                           Run&& run) {
  if ((M == 6 || M == 7) && bar != nullptr && bar[i]) {
    run([&](int lane) {
      if (lane == 0 && !merge) {
        words[i] = make_uint4(0u, 0u, 0u, 0u);
        err[i] = BIG;
      }
    });
    return;
  }
  // the load: one float4 per pixel, the group's lanes side by side
  run([&](int lane) {
#pragma unroll 1
    for (int p = lane; p < 16; p += Shape<M, W>::LANES) {
      const float4 v = reinterpret_cast<const float4*>(x + i * 64)[p];
      sh.xs[0][p] = v.x * 255.0f;
      sh.xs[1][p] = v.y * 255.0f;
      sh.xs[2][p] = v.z * 255.0f;
      sh.xs[3][p] = v.w * 255.0f;
    }
  });
  if constexpr (M == 4 || M == 5) {
    dual_search<M>(sh, iters, shake, uber, keep, run);
  } else {
    single_search<M, W>(sh, ids ? ids + i * nids : nullptr, nids, iters, shake, uber, run);
  }
  run([&](int lane) {
    if (lane != 0) return;
    Bits128 out;
    float e;
    if constexpr (M == 4 || M == 5) {
      out = pack_dual<M>(sh.ch[0]);
      e = sh.ch[0].err;
    } else {
      out = pack_chain<M>(sh.ch[0]);
      e = sh.ch[0].err;
      if (Mode<M>::AB == 0) {
        float pen = 0.0f;
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          const float d = sh.xs[3][p] - 255.0f;
          pen = pen + d * d;
        }
        e = e + pen;
      }
    }
    if (merge && !(e < err[i])) return;
    words[i] = make_uint4((uint32_t)out.lo, (uint32_t)(out.lo >> 32), (uint32_t)out.hi,
                          (uint32_t)(out.hi >> 32));
    err[i] = e;
  });
}

#ifdef __CUDACC__
// The kernel and its launcher; the host build of this header for the tests
// stops before them. Group `grp` of the CTA encodes block
// blockIdx.x * BLOCKS + grp; its phases run through GroupRun (in the narrow
// shape, a lane alone, no barrier).
template <int M, int W>
__global__ void __launch_bounds__(Shape<M, W>::THREADS, Shape<M, W>::MIN_CTAS)
bc7_full_kernel(const float* __restrict__ x, int64_t n, const int* __restrict__ ids, int nids,
                int iters, int shake, int uber, int keep, const uint8_t* __restrict__ bar,
                int merge, uint4* __restrict__ words, float* __restrict__ err) {
  constexpr int L = Shape<M, W>::LANES, B = Shape<M, W>::BLOCKS;
  __shared__ typename SharedOf<M, W>::type sh[B];
  const int grp = threadIdx.x / L;
  const int64_t i = (int64_t)blockIdx.x * B + grp;
  if (i >= n) return;
  full_block<M, W>(sh[grp], x, i, ids, nids, iters, shake, uber, keep, bar, merge, words, err,
                   GroupRun<L>(grp, threadIdx.x % L));
}

template <int M, int W>
inline void launch_shape(const float* x, long long n, const int* ids, int nids, int iters,
                         int shake, int uber, int keep, const uint8_t* bar, int merge,
                         uint32_t* words, float* err, void* stream) {
  constexpr int B = Shape<M, W>::BLOCKS;
  const unsigned grid = (unsigned)((n + B - 1) / B);
  bc7_full_kernel<M, W><<<grid, Shape<M, W>::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, ids, nids, iters, shake, uber, keep, bar, merge, reinterpret_cast<uint4*>(words), err);
}

// Launches mode M's kernel on `stream`, in the shape narrow_shape picks;
// returns cudaGetLastError().
template <int M>
inline int launch_full(const float* x, long long n, const int* ids, int nids, int iters, int shake,
                       int uber, int keep, const uint8_t* bar, int merge, uint32_t* words,
                       float* err, void* stream) {
  if (int rc = bcx::check_args(x, 4)) return rc;
  if (Mode<M>::S > 1 && (nids < 1 || nids > 64)) return (int)cudaErrorInvalidValue;
  if (iters < 0 || shake < 0 || uber < 0 || keep < 1 || keep > 2) return (int)cudaErrorInvalidValue;
  if constexpr (Shape<M>::DUAL) {
    launch_shape<M, 0>(x, n, ids, nids, iters, shake, uber, keep, bar, merge, words, err, stream);
  } else if (narrow_shape<M>(shake, uber)) {
    launch_shape<M, 1>(x, n, ids, nids, iters, shake, uber, keep, bar, merge, words, err, stream);
  } else {
    launch_shape<M, 0>(x, n, ids, nids, iters, shake, uber, keep, bar, merge, words, err, stream);
  }
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace bc7
