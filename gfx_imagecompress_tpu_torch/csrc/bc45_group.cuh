// BC4 (K2a) and BC5 (K2b): the phases of a block, the kernels and their
// launchers. Replace the Pallas kernels
// gfx_imagecompress_tpu/kernels/bc4_pallas.py:_bc4_kernel and :_bc5_kernel
// (entries encode_bc4_blocks_pallas, encode_bc5_blocks_pallas). The plain
// PyTorch versions are kernels/bc4.py:encode_bc4_blocks_plain and
// encode_bc5_blocks_plain; the search of one channel is kernels/bc4.py:
// _bc4_search, the same as K1b's alpha half (bc4_search.cuh).
//
// Bound: operations (about 37,000 a channel against 76 or 148 bytes a
// block). On one thread per block a 512x512 image (16,384 blocks) gives each
// of the SM's four schedulers one warp, whose every operation waits on the
// last: the kernel was latency-bound. The search is independent in three
// ways, and this design uses all three:
// - the two ramp families meet only at the pick;
// - a family's seeds (the 8-point family's fitted and min/max seeds, the
//   6-point family's fitted and 9 trimmed seeds) are independent, and so are
//   the candidates of a hill-climb round, all centred on the round's start;
// - BC5's two channels meet only in the error's sum.
//
// So a (block, channel) is a group of 2 * L lanes inside one warp: lanes
// [0, L) search the 8-point family, [L, 2L) the 6-point one; BC5's two
// channel groups sit side by side. Both families run one instruction stream,
// the family a value at run time (bc45_palette, bc45_levels,
// bc45_fit_terms), so that the warp does not run each family's code with
// the other's lanes masked. A family's least-squares rounds run whole on
// each of its lanes, which costs no more issue slots than masked lanes and
// needs no broadcast. The 12 seeds of both families are dealt to the
// group's 2L lanes (bc45_seed_job) and each climb round's candidates to the family's L lanes, round-robin in
// the plain loop's order; a lane keeps its first best per family in a slot.
// After the group's barrier every lane of the family scans the slots (least
// error, the lowest candidate index on a tie, strict against the round's
// start): the sequential loop's winner. A round after the first evaluates
// only the candidates that can win (outside the previous round's box, whose
// candidates the previous round already bettered or matched), compacted, so
// that a warp runs as many evaluations as its busiest lane needs. After the
// climb every lane of the group makes the pick (bc4_pick, a tie to the
// 8-point family) and assigns the winner's indices of its pixels; lane 0 of
// the block packs and writes.
//
// A candidate's error takes the least |v - entry| over the 8 entries and
// squares it once: the squares of the plain version, rounded, are monotone
// in |v - entry|, so the least square is the square of the least distance,
// bit for bit (16 operations a pixel where the plain version has 23). The
// ramp's divisions by 7 and 5 are a multiply and a shift, exact for every
// numerator a ramp takes (static_assert below).
//
// The launch shape (lanes per family, threads per CTA) was swept on the
// H100 at 1, 2, 4 and 8 lanes and 128 or 256 threads (PERF.md, section 6):
// more lanes add issue slots (the whole fit on every lane, seeds and rounds
// that do not divide evenly), which at 512x512 and above cost more than the
// extra warps hide, so 1 lane per family wins there; 8 lanes win on small
// images (13x257).
//
// The phases run through `run`: on the card the lanes, then the warp's
// __syncwarp; in the tests' host build a loop over the lanes. No sum is
// reordered and every winner is the sequential loop's, so the words and
// errors are the plain versions'.
#pragma once
#include "bc4_search.cuh"

namespace bcx {

// The launch shape of both kernels: lanes per block, channel and family,
// threads per CTA (kernels/bc4.py BC45_LANES, BC45_THREADS); the fastest of
// the sweep at 512x512 for each kernel (PERF.md, section 6).
constexpr int BC45_LANES = 1;
constexpr int BC45_THREADS = 256;

template <int L, int NCH, int T>
struct Bc45Shape {
  static_assert(L <= 8 && 32 % (2 * L * NCH) == 0, "a block lies inside one warp");
  static_assert(T % 32 == 0, "whole warps");
  enum {
    BLOCK_LANES = 2 * L * NCH,  // lanes per block
    BLOCKS = T / (2 * L * NCH),  // blocks per CTA
  };
};

constexpr float BC45_NONE = 3.0e38f;  // a slot that holds no candidate

// ---- what a lane keeps between phases
struct Bc45Lane {
  float v[16];          // the block's channel, 0..255
  float vlo, vhi;       // its least and greatest value
  float e0, e1;         // the least-squares endpoints of the lane's family
  int fs0, fs1;         // and its fitted seed
  int mm0, mm1;         // the 8-point family's min/max seed
  int lo3[3], hi3[3];   // the 6-point family's trimmed seeds: the sorted
                        // values' 3 lowest and 3 highest
  int a0, a1;           // the family's start of the current round
  float err;            // and its error
  int box[4];           // the previous round's box: a0 in [box[0], box[1]],
                        // a1 in [box[2], box[3]]
};

// ---- what the group of a (block, channel) shares
template <int L>
struct Bc45Chan {
  float v[16];          // the channel, 0..255 (a lane's own pixels, by index)
  float se[2][2][2 * L];  // per buffer, family and lane: its best candidate's
  int sc[2][2][2 * L];    // error and index (-1: none); the seeds use the
                          // group's 2L lanes, a climb round its family's L
  int fa0[2], fa1[2];   // per family, the result of the climb
  float ferr[2];
  uint32_t idx[2 * L][2];  // each lane's bits of the winner's indices
  int pad;              // an odd number of words: the groups of a warp read a
                        // word at once without bank conflicts
};

static_assert(sizeof(Bc45Chan<1>) % 8 == 4 && sizeof(Bc45Chan<2>) % 8 == 4,
              "an odd number of words");

// ---- the ramp of either family, the family given at run time
constexpr int BC45_M7 = 9363, BC45_M5 = 13108;  // (n * M) >> 16 == n / 7, n / 5

constexpr bool bc45_divisions_exact() {
  for (int n = 0; n <= 7 * 255 + 3; ++n)
    if (((n * BC45_M7) >> 16) != n / 7) return false;
  for (int n = 0; n <= 5 * 255 + 2; ++n)
    if (((n * BC45_M5) >> 16) != n / 5) return false;
  return true;
}
static_assert(bc45_divisions_exact(), "the ramps' divisions");

// bc4_palette<eight> as floats: entry i's numerator steps by a1 - a0
__device__ __forceinline__ void bc45_palette(int a0, int a1, bool eight, float (&pal)[8]) {
  const int m = eight ? BC45_M7 : BC45_M5;
  const int d = a1 - a0;
  int num = (eight ? 6 : 4) * a0 + a1 + (eight ? 3 : 2);  // entry 2
  pal[0] = i2f(a0);
  pal[1] = i2f(a1);
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    const float f = i2f((num * m) >> 16);
    pal[i] = (i < 6 || eight) ? f : (i == 6 ? 0.0f : 255.0f);
    num += d;
  }
}

// bc4_assign_err: the least |v - entry|, squared, summed left to right
__device__ __forceinline__ float bc45_err(const float (&v)[16], int a0, int a1, bool eight) {
  float pal[8];
  bc45_palette(a0, a1, eight, pal);
  float sum = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    float d = fabsf(v[p] - pal[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) d = fminf(d, fabsf(v[p] - pal[k]));
    const float e = d * d;
    sum = (p == 0) ? e : sum + e;
  }
  return sum;
}

// The levels of bc4_family8 / bc4_family6's fits (W8, W6)
__device__ __forceinline__ float bc45_level(int k, bool six) {
  switch (k) {
    case 0: return 0.0f;
    case 1: return 1.0f;
    case 2: return six ? (float)(1.0 / 5.0) : (float)(1.0 / 7.0);
    case 3: return six ? (float)(2.0 / 5.0) : (float)(2.0 / 7.0);
    case 4: return six ? (float)(3.0 / 5.0) : (float)(3.0 / 7.0);
    case 5: return six ? (float)(4.0 / 5.0) : (float)(4.0 / 7.0);
    case 6: return six ? 0.0f : (float)(5.0 / 7.0);
    default: return six ? 0.0f : (float)(6.0 / 7.0);
  }
}

// One pixel's terms of a least-squares round of bc4_fit_ramp<six, six ? 6 : 8>,
// the same operations in the same order: the 6-point family's slots 6 and 7
// are its literal 0 and 255 (pp 0 and 255), which take the pixel out of the
// fit (m = 0) where they are nearer; the 8-point family's m stays 1 and
// multiplies exactly
__device__ __forceinline__ void bc45_fit_terms(float v, const float (&pp)[8],
                                               const float (&lv)[8], bool six, float (&t)[5]) {
  float best = 0.0f, alpha = 0.0f, m = 1.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float d = (v - pp[k]) * (v - pp[k]);
    if (k == 0 || d < best) {
      best = d;
      if (k >= 6 && six) m = 0.0f;
      else alpha = lv[k];
    }
  }
  const float oa = 1.0f - alpha;
  t[0] = m * (oa * oa);
  t[1] = (m * alpha) * oa;
  t[2] = (m * alpha) * alpha;
  t[3] = (m * oa) * v;
  t[4] = (m * alpha) * v;
}

// The round's levels and the values they interpolate between e0 and e1
__device__ __forceinline__ void bc45_levels(float e0, float e1, bool six, float (&lv)[8],
                                            float (&pp)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    lv[k] = bc45_level(k, six);
    pp[k] = (k >= 6 && six) ? (k == 6 ? 0.0f : 255.0f) : e0 + lv[k] * (e1 - e0);
  }
}

// The seeds of both families, 12 jobs dealt to the group's 2L lanes: job p
// to lane p mod 2L. The fitted seeds need their family's fit, so the 8-point
// family's (f 0, c 0) is job 0 (lane 0) and the 6-point family's (f 1, c 0)
// job L (lane L, its family's first); the other jobs are, in order, the
// 8-point min/max seed (0, 1) and the 6-point trimmed seeds (1, 1..9).
template <int L>
__device__ __forceinline__ void bc45_seed_job(int p, int& f, int& c) {
  const int rank = p - 1 - (p > L ? 1 : 0);
  f = (p == 0) ? 0 : (p == L ? 1 : (rank == 0 ? 0 : 1));
  c = (p == 0 || p == L) ? 0 : (rank == 0 ? 1 : rank);
}

// Seed c of family f (bc4_family8's and bc4_family6's order): c 0 the fitted
// seed, the lane's own family's; 8-point c 1 the min/max seed; 6-point c
// 1..9 the trimmed seeds
__device__ __forceinline__ void bc45_seed(const Bc45Lane& r, int f, int c, int& s0, int& s1) {
  if (c == 0) {
    s0 = r.fs0;
    s1 = r.fs1;
  } else if (f == 0) {
    s0 = r.mm0;
    s1 = r.mm1;
  } else {
    const int i = (c - 1) / 3, j = (c - 1) - 3 * i;
    s0 = (i == 0) ? r.lo3[0] : (i == 1 ? r.lo3[1] : r.lo3[2]);
    s1 = max((j == 0) ? r.hi3[0] : (j == 1 ? r.hi3[1] : r.hi3[2]), s0);
  }
}

// The endpoints of candidate (d0, d1) around (a0, a1), and whether it can
// win: the endpoint order right for the family and outside `box` (a
// candidate in the previous round's box, or the centre itself in round 0,
// has at least the round's starting error, which only a smaller one beats)
__device__ __forceinline__ bool bc45_candidate(const Bc45Lane& r, int d0, int d1, bool eight,
                                               int& c0, int& c1) {
  c0 = clamp_i(r.a0 + d0, 0, 255);
  c1 = clamp_i(r.a1 + d1, 0, 255);
  const bool inside = c0 >= r.box[0] && c0 <= r.box[1] && c1 >= r.box[2] && c1 <= r.box[3];
  return !inside && (eight ? (c0 > c1) : (c0 <= c1));
}

// The in-order scan of family f's first n slots: the least error, the
// lowest candidate on a tie; the winner if it is below `inc`, else -1
template <int L>
__device__ __forceinline__ int bc45_scan(const Bc45Chan<L>& sh, int b, int f, int n, float inc,
                                         float& e) {
  float be = BC45_NONE;
  int bt = -1;
#pragma unroll
  for (int q = 0; q < 2 * L; ++q) {
    if (q >= n) break;
    const int t = sh.sc[b][f][q];
    const float et = sh.se[b][f][q];
    if (t >= 0 && (et < be || (et == be && t < bt))) {
      be = et;
      bt = t;
    }
  }
  if (bt >= 0 && be < inc) {
    e = be;
    return bt;
  }
  return -1;
}

// Lane k's first best of a round's candidates t = k, k + L, ... (t = (d0 +
// rad) * (2 rad + 1) + d1 + rad, the plain loop's order) into its slot of
// buffer b. Round 0 (any radius) walks its candidates; a later round
// (radius 1: 8 candidates) first marks the ones that can win and then
// evaluates only those, so that a warp runs as many evaluations as its
// busiest lane needs, not every candidate some lane needs.
template <int L>
__device__ __forceinline__ void bc45_round(Bc45Chan<L>& sh, const Bc45Lane& r, int b, int f,
                                           int k, int rd, int radius) {
  const bool eight = f == 0;
  float be = BC45_NONE;
  int bt = -1;
  if (rd == 0) {
    const int side = 2 * radius + 1, n = radius >= 0 ? side * side : 0;
    int q0 = k / side, q1 = k - q0 * side;  // t = q0 * side + q1
#pragma unroll 1
    for (int t = k; t < n; t += L) {
      int c0, c1;
      if (bc45_candidate(r, q0 - radius, q1 - radius, eight, c0, c1)) {
        const float e = bc45_err(r.v, c0, c1, eight);
        if (e < be) {
          be = e;
          bt = t;
        }
      }
      q1 += L;
      while (q1 >= side) {
        q1 -= side;
        ++q0;
      }
    }
  } else {
    uint32_t need = 0u;
#pragma unroll
    for (int j = 0; j < (9 + L - 1) / L; ++j) {
      const int t = k + L * j;
      int c0, c1;
      if (t < 9 && bc45_candidate(r, t / 3 - 1, t % 3 - 1, eight, c0, c1)) need |= 1u << j;
    }
#pragma unroll 1
    while (need) {
      const int t = k + L * (__ffs((int)need) - 1);
      need &= need - 1u;
      int c0, c1;
      bc45_candidate(r, t / 3 - 1, t % 3 - 1, eight, c0, c1);
      const float e = bc45_err(r.v, c0, c1, eight);
      if (e < be) {
        be = e;
        bt = t;
      }
    }
  }
  sh.se[b][f][k] = be;
  sh.sc[b][f][k] = bt;
}

// ---- the search of one block's NCH channels (K2a: 1, K2b: 2). Block lane l:
// channel l / (2L), family (l / L) % 2 (0: 8-point), lane k = l % L of the
// family. px: the block's first pixel; C floats per pixel (1: BC4's (N,16)
// rows, read as four float4). Each channel's group leaves its families'
// results in sh[ch].fa0/fa1/ferr and the winner's indices in sh[ch].idx.
template <int L, int NCH, class Run>
__device__ __forceinline__ void bc45_search(Bc45Chan<L> (&sh)[NCH], const float* __restrict__ px,
                                            int C, int iters, int radius, int rounds,
                                            Run&& run) {
  // the channel, 0..255, its range, the fit's start
  run([&](int l, Bc45Lane& r) {
    const int ch = l / (2 * L);
    if (C == 1) {
      const float4* p4 = reinterpret_cast<const float4*>(px);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = p4[q];
        r.v[4 * q + 0] = v.x * 255.0f;
        r.v[4 * q + 1] = v.y * 255.0f;
        r.v[4 * q + 2] = v.z * 255.0f;
        r.v[4 * q + 3] = v.w * 255.0f;
      }
    } else {
#pragma unroll
      for (int p = 0; p < 16; ++p) r.v[p] = px[p * C + ch] * 255.0f;
    }
    // lane g of the group copies pixels g, g + 2L, ... to shared memory (a
    // lane's registers are indexed at compile time only)
#pragma unroll
    for (int j = 0; j < (16 + 2 * L - 1) / (2 * L); ++j) {
      const int p = l % (2 * L) + 2 * L * j;
      if (p < 16) sh[ch].v[p] = (C == 1 ? px[p] : px[p * C + ch]) * 255.0f;
    }
    r.vlo = r.v[0];
    r.vhi = r.v[0];
#pragma unroll
    for (int p = 1; p < 16; ++p) {
      r.vlo = fminf(r.vlo, r.v[p]);
      r.vhi = fmaxf(r.vhi, r.v[p]);
    }
    r.e0 = r.vlo;
    r.e1 = r.vhi;
  });
  // the least-squares rounds, whole on every lane of the family
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    run([&](int l, Bc45Lane& r) {
      const bool six = (l / L) % 2 == 1;
      float lv[8], pp[8], q[5];
      bc45_levels(r.e0, r.e1, six, lv, pp);
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        float t[5];
        bc45_fit_terms(r.v[p], pp, lv, six, t);
#pragma unroll
        for (int j = 0; j < 5; ++j) q[j] = (p == 0) ? t[j] : q[j] + t[j];
      }
      bc4_solve(q[0], q[1], q[2], q[3], q[4], r.e0, r.e1);
    });
  }
  // the seeds of both families, dealt to the group's lanes (bc45_seed_job):
  // each lane's first best per family into buffer 0
  run([&](int l, Bc45Lane& r) {
    const int ch = l / (2 * L), g = l % (2 * L), f = g / L;
    const int vmin = round_u8(r.vlo), vmax = round_u8(r.vhi);
    r.mm0 = (vmax > vmin) ? vmax : min(vmax + 1, 255);
    r.mm1 = vmin;
    const int hi = round_u8(fmaxf(r.e0, r.e1)), lo = round_u8(fminf(r.e0, r.e1));
    r.fs0 = (f == 1) ? lo : ((hi > lo) ? hi : min(hi + 1, 255));
    r.fs1 = (f == 1) ? hi : lo;
    float sv[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) sv[p] = r.v[p];
    bc4_sort16(sv);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      r.lo3[i] = round_u8(sv[i]);
      r.hi3[i] = round_u8(sv[15 - i]);
    }
    float be8 = BC45_NONE, be6 = BC45_NONE;
    int bc8 = -1, bc6 = -1;
#pragma unroll 1
    for (int p = g; p < 12; p += 2 * L) {
      int jf, c, s0, s1;
      bc45_seed_job<L>(p, jf, c);
      bc45_seed(r, jf, c, s0, s1);
      const float e = bc45_err(r.v, s0, s1, jf == 0);
      if (jf == 0 && (e < be8 || (e == be8 && c < bc8))) {
        be8 = e;
        bc8 = c;
      }
      if (jf == 1 && (e < be6 || (e == be6 && c < bc6))) {
        be6 = e;
        bc6 = c;
      }
    }
    sh[ch].se[0][0][g] = be8;
    sh[ch].sc[0][0][g] = bc8;
    sh[ch].se[0][1][g] = be6;
    sh[ch].sc[0][1][g] = bc6;
  });
  // the climb: round rd scans buffer rd % 2 (the seeds, or round rd - 1),
  // moves to the winner, deals its own candidates into the other buffer
  auto advance = [&](Bc45Lane& r, int ch, int f, int rd) {
    float e;
    if (rd == 0) {
      const int w = bc45_scan(sh[ch], 0, f, 2 * L, BC45_NONE, e);
      bc45_seed(r, f, w, r.a0, r.a1);  // the fitted seed is always a candidate
      r.err = e;
      r.box[0] = r.box[1] = r.a0;
      r.box[2] = r.box[3] = r.a1;
    } else {
      const int rad = (rd == 1) ? radius : 1, side = 2 * rad + 1;
      const int w = bc45_scan(sh[ch], rd % 2, f, L, r.err, e);
      r.box[0] = clamp_i(r.a0 - rad, 0, 255);
      r.box[1] = clamp_i(r.a0 + rad, 0, 255);
      r.box[2] = clamp_i(r.a1 - rad, 0, 255);
      r.box[3] = clamp_i(r.a1 + rad, 0, 255);
      if (w >= 0) {
        r.a0 = clamp_i(r.a0 + w / side - rad, 0, 255);
        r.a1 = clamp_i(r.a1 + w % side - rad, 0, 255);
        r.err = e;
      }
    }
  };
#pragma unroll 1
  for (int rd = 0; rd < rounds; ++rd) {
    run([&](int l, Bc45Lane& r) {
      const int ch = l / (2 * L), f = (l / L) % 2, k = l % L;
      advance(r, ch, f, rd);
      bc45_round(sh[ch], r, (rd + 1) % 2, f, k, rd, radius);
    });
  }
  // the families' results
  run([&](int l, Bc45Lane& r) {
    const int ch = l / (2 * L), f = (l / L) % 2, k = l % L;
    advance(r, ch, f, rounds > 0 ? rounds : 0);
    if (k == 0) {
      sh[ch].fa0[f] = r.a0;
      sh[ch].fa1[f] = r.a1;
      sh[ch].ferr[f] = r.err;
    }
  });
  // the pick, and the winner's indices of pixels g, g + 2L, ... on lane g of
  // the group
  run([&](int l, Bc45Lane&) {
    const int ch = l / (2 * L), g = l % (2 * L);
    const Bc45Chan<L>& s = sh[ch];
    int a0, a1;
    float e;
    float pal[8];
    if (bc4_pick(s.fa0[0], s.fa1[0], s.ferr[0], s.fa0[1], s.fa1[1], s.ferr[1], a0, a1, e))
      bc4_palette<true>(a0, a1, pal);
    else
      bc4_palette<false>(a0, a1, pal);
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int j = 0; j < (16 + 2 * L - 1) / (2 * L); ++j) {
      const int p = g + 2 * L * j;
      if (p >= 16) break;
      const uint32_t q = (uint32_t)bc4_nearest(s.v[p], pal);
      if (p < 8) lo |= q << (3 * p);
      else hi |= q << (3 * (p - 8));
    }
    sh[ch].idx[g][0] = lo;
    sh[ch].idx[g][1] = hi;
  });
}

// Lane 0 of the block: the pick of each channel, its indices, the pack; the
// words (2 per channel) and the error (the channels' errors added in order)
template <int L, int NCH>
__device__ __forceinline__ void bc45_finish(const Bc45Chan<L> (&sh)[NCH],
                                            uint32_t (&w)[2 * NCH], float& err) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const Bc45Chan<L>& s = sh[ch];
    int a0, a1, idx[16];
    float e;
    bc4_pick(s.fa0[0], s.fa1[0], s.ferr[0], s.fa0[1], s.fa1[1], s.ferr[1], a0, a1, e);
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int g = 0; g < 2 * L; ++g) {
      lo |= s.idx[g][0];
      hi |= s.idx[g][1];
    }
#pragma unroll
    for (int p = 0; p < 16; ++p)
      idx[p] = (int)(((p < 8 ? lo >> (3 * p) : hi >> (3 * (p - 8)))) & 7u);
    pack_dxt5(a0, a1, idx, w[2 * ch], w[2 * ch + 1]);
    err = (ch == 0) ? e : err + e;
  }
}

#ifdef __CUDACC__
// The kernels and their launchers; the host build of this header for the
// tests stops before them. A block lane past the last block encodes the last
// block once more and writes nothing, so that every warp runs the same
// phases.
template <int L, int NCH, int T>
__device__ __forceinline__ void bc45_cta(const float* __restrict__ x, int64_t n, int C,
                                         int iters, int radius, int rounds,
                                         uint32_t* __restrict__ words, float* __restrict__ err) {
  constexpr int BL = Bc45Shape<L, NCH, T>::BLOCK_LANES, B = Bc45Shape<L, NCH, T>::BLOCKS;
  static_assert(sizeof(Bc45Chan<L>) * B * NCH <= 48 * 1024, "static shared memory");
  __shared__ Bc45Chan<L> sh[B][NCH];
  const int j = threadIdx.x / BL, l = threadIdx.x % BL;
  const int64_t i = (int64_t)blockIdx.x * B + j;
  const bool valid = i < n;
  const int64_t ie = valid ? i : n - 1;
  Bc45Lane regs;
  auto run = [&](auto&& f) {
    f(l, regs);
    __syncwarp();
  };
  bc45_search<L, NCH>(sh[j], x + ie * 16 * (NCH == 1 ? 1 : C), NCH == 1 ? 1 : C, iters, radius,
                      rounds, run);
  if (valid && l == 0) {
    uint32_t w[2 * NCH];
    float e;
    bc45_finish<L, NCH>(sh[j], w, e);
    if constexpr (NCH == 1)
      reinterpret_cast<uint2*>(words)[i] = make_uint2(w[0], w[1]);
    else
      reinterpret_cast<uint4*>(words)[i] = make_uint4(w[0], w[1], w[2], w[3]);
    err[i] = e;
  }
}

template <int L, int T>
__global__ void __launch_bounds__(T)
bc4_kernel(const float* __restrict__ x, int64_t n, int iters, int radius, int rounds,
           uint32_t* __restrict__ words, float* __restrict__ err) {
  bc45_cta<L, 1, T>(x, n, 1, iters, radius, rounds, words, err);
}

template <int L, int T>
__global__ void __launch_bounds__(T)
bc5_kernel(const float* __restrict__ x, int64_t n, int C, int iters, int radius, int rounds,
           uint32_t* __restrict__ words, float* __restrict__ err) {
  bc45_cta<L, 2, T>(x, n, C, iters, radius, rounds, words, err);
}

// Launch on `stream`, do not synchronise; return cudaGetLastError().
template <int L, int T = BC45_THREADS>
inline int launch_bc4(const float* x, long long n, uint32_t* words, float* err, int iters,
                      int radius, int rounds, void* stream) {
  if (int rc = check_args(x, 4)) return rc;
  constexpr int B = Bc45Shape<L, 1, T>::BLOCKS;
  bc4_kernel<L, T><<<(unsigned)((n + B - 1) / B), T, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, iters, radius, rounds, words, err);
  return (int)cudaGetLastError();
}

template <int L, int T = BC45_THREADS>
inline int launch_bc5(const float* x, long long n, int C, uint32_t* words, float* err,
                      int iters, int radius, int rounds, void* stream) {
  if (int rc = check_args(x, C)) return rc;
  if (C < 2) return (int)cudaErrorInvalidValue;
  constexpr int B = Bc45Shape<L, 2, T>::BLOCKS;
  bc5_kernel<L, T><<<(unsigned)((n + B - 1) / B), T, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, C, iters, radius, rounds, words, err);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace bcx
