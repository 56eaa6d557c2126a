// BC3 (K1b) and BC2 (K1c): the phases of a block, the kernels and their
// launchers. Replace the Pallas kernels
// gfx_imagecompress_tpu/kernels/bc1_pallas.py:_bc3_kernel and :_bc2_kernel
// (entries encode_bc3_blocks_pallas, encode_bc2_blocks_pallas). The plain
// PyTorch versions are kernels/bc1.py:encode_bc3_blocks_plain and
// encode_bc2_blocks_plain. Word order: alpha pair, then colour pair. The
// error is the weighted colour error plus the unweighted alpha error, added
// in that order.
//
// Bound: operations. The colour half is BC1's 4-colour, opaque search with
// the refine (about 30,000 operations a block); BC3's alpha half is the
// scalar search of bc4_search.cuh (about 37,000 more), BC2's explicit alpha
// 16 roundings.
//
// K1b: the colour half runs on K1a's lane groups (bc1_search.cuh:
// bc1_group_load, _start, _refine, _assign, _race with the 4-colour mode
// alone, opaque): BC1_LANES lanes per block, BC1_CTA_BLOCKS blocks per CTA,
// the block in shared memory; the load also puts the block's alpha, scaled
// to 0..255, into shared memory (Bc3Alpha). The alpha search is two
// independent families that meet only at the pick (bc4_search.cuh). A CTA
// holds, beside the colour groups (warps 0-1), the 8-point family of its
// blocks' alpha in a warp of its own (warp 2) and the 6-point family in
// another (warp 3), one thread per (block, family) running the family whole
// (bc4_family8 / bc4_family6); each family runs without
// divergence and concurrently with the colour half. After a __syncthreads
// both family threads of a block make the pick (bc4_pick) and assign the
// winner's indices of 8 pixels each; after one more, the colour group's lane
// 0 races the colour candidates, packs and writes. Two threads per (block,
// family) and a finish on lane 0 alone read slower on the H100 (PERF.md).
// The colour phases run through `run` as in bc1_search.cuh: on the card the
// lanes and then the warp's __syncwarp, in the tests' host build a loop over
// the lanes. At most 128 registers, no spills (ptxas -v, PERF.md).
//
// K1c: one thread per block (bcx::THREADS per CTA), the one-thread colour
// search of bc1_search.cuh (bc1_search) and the explicit alpha; on K1a's
// lane groups it read slower (PERF.md).
//
// No sum is reordered and every winner is the sequential loop's, so the
// words and errors are the plain versions'.
#pragma once
#include "bc1_search.cuh"
#include "bc4_search.cuh"

namespace bcx {

// K1b's launch shape: the colour groups' threads, then one thread per
// (block, alpha family)
constexpr int BC3_COLOUR = BC1_CTA_BLOCKS * BC1_LANES;
constexpr int BC3_THREADS = BC3_COLOUR + 2 * BC1_CTA_BLOCKS;
static_assert(BC3_COLOUR % 32 == 0 && BC1_CTA_BLOCKS % 32 == 0,
              "each role holds whole warps");

// A block's alpha and what its alpha phases leave.
struct Bc3Alpha {
  float a[16];          // alpha, 0..255
  int fa0[2], fa1[2];   // each family's endpoints (0: 8-point, 1: 6-point)
  float ferr[2];        // and its error
  uint32_t idx[2];      // the winner's indices of pixels 0-7, 8-15
  float pad[3];         // an odd number of words: the family threads of 32
                        // blocks read a[p] at once without bank conflicts
};

inline Bc1Budget bc23_budget(float w0, float w1, float w2, int iters, int passes,
                             int adaptive) {
  Bc1Budget bud;
  bud.w[0] = w0; bud.w[1] = w1; bud.w[2] = w2;
  bud.iters = iters; bud.passes = passes; bud.allow_three = 0;
  bud.use_alpha = 0; bud.athr255 = 0.0f; bud.adaptive = adaptive; bud.b3d = 0;
  return bud;
}

// The colour half of K1b: the 4-colour mode, opaque, with the refine.
template <class Run>
__device__ __forceinline__ void bc3_colour(const Bc1Block& b, Bc1Fit& f, const Bc1Budget& bud,
                                           Run&& run) {
  bc1_group_start<true, false>(b, f, bud, run);
  bc1_group_refine<true, false>(b, f, bud, run);
  bc1_group_assign<true, false>(b, f, run);
}

// ---- K1c: one thread, the block's 16 RGBA pixels in 0..255

__device__ __forceinline__ void bc2_block(const float (&rgba)[4][16], const Bc1Budget& bud,
                                          uint4& w, float& e) {
  float xs[3][16];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    xs[0][p] = rgba[0][p];
    xs[1][p] = rgba[1][p];
    xs[2][p] = rgba[2][p];
  }
  uint32_t a0, a1, pidx;
  float cerr;
  bc1_search(xs, bud, a0, a1, pidx, cerr);
  // explicit alpha, rounding of amd_bcx_helpers.cpp:107-123
  uint32_t aw0 = 0u, aw1 = 0u;
  int asum = 0;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int c = round_u8(rgba[3][p]);
    const int hi = c >> 4;
    const int q = min((c + (hi < 8 ? 7 : 8) - hi) >> 4, 15);
    if (p < 8) aw0 |= (uint32_t)q << (4 * p);
    else aw1 |= (uint32_t)q << (4 * (p - 8));
    const int d = c - q * 17;
    asum += d * d;                                  // exact in int and in f32
  }
  w = make_uint4(aw0, aw1, a0 | (a1 << 16), pidx);
  e = cerr + (float)asum;
}

// ---- K1b

// One alpha family of a block on one thread; its endpoints and error into
// al.fa0/fa1/ferr[EIGHT ? 0 : 1].
template <bool EIGHT>
__device__ __forceinline__ void bc3_family(Bc3Alpha& al, int iters, int radius, int rounds) {
  constexpr int fam = EIGHT ? 0 : 1;
  float v[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) v[p] = al.a[p];
  int a0, a1;
  float e;
  if (EIGHT) bc4_family8(v, iters, radius, rounds, a0, a1, e);
  else bc4_family6(v, iters, radius, rounds, a0, a1, e);
  al.fa0[fam] = a0;
  al.fa1[fam] = a1;
  al.ferr[fam] = e;
}

// The thread of family h assigns the winner's indices of pixels
// 8h..8h+7
__device__ __forceinline__ void bc3_alpha_half(Bc3Alpha& al, int h) {
  int a0, a1;
  float aerr;
  float pal[8];
  if (bc4_pick(al.fa0[0], al.fa1[0], al.ferr[0], al.fa0[1], al.fa1[1], al.ferr[1], a0, a1,
               aerr))
    bc4_palette<true>(a0, a1, pal);
  else
    bc4_palette<false>(a0, a1, pal);
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) bits |= (uint32_t)bc4_nearest(al.a[8 * h + j], pal) << (3 * j);
  al.idx[h] = bits;
}

// lane 0: the colour race, the pick, the alpha indices of the two halves,
// the pack; the block's words and error
__device__ __forceinline__ void bc3_finish(const Bc1Block& b, const Bc1Fit& f,
                                           const Bc3Alpha& al, uint4& w, float& e) {
  uint2 cw;
  float cerr;
  bc1_group_race<false>(b, f, nullptr, cw, cerr);
  int a0, a1, idx[16];
  float aerr;
  bc4_pick(al.fa0[0], al.fa1[0], al.ferr[0], al.fa0[1], al.fa1[1], al.ferr[1], a0, a1, aerr);
#pragma unroll
  for (int p = 0; p < 16; ++p) idx[p] = (int)((al.idx[p >> 3] >> (3 * (p & 7))) & 7u);
  uint32_t aw0, aw1;
  pack_dxt5(a0, a1, idx, aw0, aw1);
  w = make_uint4(aw0, aw1, cw.x, cw.y);
  e = cerr + aerr;
}

#ifdef __CUDACC__
// The kernels and their launchers; the host build of this header for the
// tests stops before them. In K1b a group or family thread past the last
// block encodes the last block once more and writes nothing, so that every
// warp runs the same phases.

// Threads [0, BC3_COLOUR): colour group j = t / BC1_LANES. Then the
// 8-point family's BC1_CTA_BLOCKS threads and the 6-point family's: block j.
__global__ void __launch_bounds__(BC3_THREADS, (512 + BC3_THREADS - 1) / BC3_THREADS)
bc3_kernel(const float* __restrict__ x, int64_t n, Bc1Budget bud, int a_iters, int a_radius,
           int a_rounds, uint4* __restrict__ words, float* __restrict__ err) {
  constexpr int B = BC1_CTA_BLOCKS, L = BC1_LANES;
  __shared__ Bc1Block blk[B];
  __shared__ Bc1Fit fit[B];
  __shared__ Bc3Alpha al[B];
  const int t = threadIdx.x;
  const bool colour = t < BC3_COLOUR;
  const int fam = colour ? 0 : (t - BC3_COLOUR) / B;
  const int j = colour ? t / L : (t - BC3_COLOUR) % B;
  const int lane = colour ? t % L : 0;
  const int64_t i = (int64_t)blockIdx.x * B + j;
  const bool valid = i < n;
  const int64_t ie = valid ? i : n - 1;
  Bc1Lane regs;
  auto run = [&](auto&& f) {
    f(lane, regs);
    __syncwarp();
  };
  if (colour) bc1_group_load<false>(blk[j], x + ie * 64, 4, bud, run, al[j].a);
  __syncthreads();
  if (colour) bc3_colour(blk[j], fit[j], bud, run);
  else if (fam == 0) bc3_family<true>(al[j], a_iters, a_radius, a_rounds);
  else bc3_family<false>(al[j], a_iters, a_radius, a_rounds);
  __syncthreads();
  if (!colour) bc3_alpha_half(al[j], fam);
  __syncthreads();
  if (colour && valid && lane == 0) {
    uint4 w;
    float e;
    bc3_finish(blk[j], fit[j], al[j], w, e);
    words[i] = w;
    err[i] = e;
  }
}

// One thread per block.
__global__ void __launch_bounds__(THREADS)
bc2_kernel(const float* __restrict__ x, int64_t n, Bc1Budget bud, uint4* __restrict__ words,
           float* __restrict__ err) {
  const int64_t i = block_index();
  if (i >= n) return;
  float rgba[4][16];
  load_block<4>(x + i * 64, 4, rgba);
  uint4 w;
  float e;
  bc2_block(rgba, bud, w, e);
  words[i] = w;
  err[i] = e;
}

// Launch on `stream`, do not synchronise; return cudaGetLastError().
inline int launch_bc3(const float* x, long long n, const Bc1Budget& bud, int a_iters,
                      int a_radius, int a_rounds, uint32_t* words, float* err, void* stream) {
  if (int rc = check_args(x, 4)) return rc;
  const unsigned grid = (unsigned)((n + BC1_CTA_BLOCKS - 1) / BC1_CTA_BLOCKS);
  bc3_kernel<<<grid, BC3_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, bud, a_iters, a_radius, a_rounds, reinterpret_cast<uint4*>(words), err);
  return (int)cudaGetLastError();
}

inline int launch_bc2(const float* x, long long n, const Bc1Budget& bud, uint32_t* words,
                      float* err, void* stream) {
  if (int rc = check_args(x, 4)) return rc;
  bc2_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, bud, reinterpret_cast<uint4*>(words), err);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace bcx
