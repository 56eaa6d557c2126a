// BC3 kernel (K1b) and BC2 kernel (K1c). Replace the Pallas kernels
// gfx_imagecompress_tpu/kernels/bc1_pallas.py:_bc3_kernel and :_bc2_kernel
// (entries encode_bc3_blocks_pallas, encode_bc2_blocks_pallas). Both are thin:
// the 4-colour-only search of bc1_search.cuh on RGB plus, for BC3, the scalar
// search of bc4_search.cuh on alpha and, for BC2, explicit 4-bit alpha. One
// launch does both halves from one load of the block. Bound: operations (see
// the two headers). Word order: alpha pair, then colour pair. The error is
// the weighted colour error plus the unweighted alpha error.
//
// (N,16,4) float32 in [0,1] -> (N,4) uint32 words, (N,) float32 error.
#include "bc1_search.cuh"
#include "bc4_search.cuh"

namespace {

__device__ __forceinline__ void colour_half(const float (&rgba)[4][16],
                                            const bcx::Bc1Budget& bud, uint32_t& cw0,
                                            uint32_t& cw1, float& cerr) {
  float xs[3][16];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    xs[0][p] = rgba[0][p];
    xs[1][p] = rgba[1][p];
    xs[2][p] = rgba[2][p];
  }
  uint32_t a0, a1, pidx;
  bcx::bc1_search(xs, bud, a0, a1, pidx, cerr);
  cw0 = a0 | (a1 << 16);
  cw1 = pidx;
}

__global__ void __launch_bounds__(bcx::THREADS)
bc3_kernel(const float* __restrict__ x, int64_t n, bcx::Bc1Budget bud, int a_iters,
           int a_radius, int a_rounds, uint4* __restrict__ words,
           float* __restrict__ err) {
  const int64_t i = bcx::block_index();
  if (i >= n) return;
  float rgba[4][16];
  bcx::load_block<4>(x + i * 64, 4, rgba);
  uint32_t cw0, cw1, aw0, aw1;
  float cerr, aerr;
  colour_half(rgba, bud, cw0, cw1, cerr);
  int a0, a1, idx[16];
  bcx::bc4_search(rgba[3], a_iters, a_radius, a_rounds, a0, a1, idx, aerr);
  bcx::pack_dxt5(a0, a1, idx, aw0, aw1);
  words[i] = make_uint4(aw0, aw1, cw0, cw1);
  err[i] = cerr + aerr;
}

__global__ void __launch_bounds__(bcx::THREADS)
bc2_kernel(const float* __restrict__ x, int64_t n, bcx::Bc1Budget bud,
           uint4* __restrict__ words, float* __restrict__ err) {
  const int64_t i = bcx::block_index();
  if (i >= n) return;
  float rgba[4][16];
  bcx::load_block<4>(x + i * 64, 4, rgba);
  uint32_t cw0, cw1;
  float cerr;
  colour_half(rgba, bud, cw0, cw1, cerr);
  // explicit alpha, rounding of amd_bcx_helpers.cpp:107-123
  uint32_t aw0 = 0u, aw1 = 0u;
  int asum = 0;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const int c = bcx::round_u8(rgba[3][p]);
    const int hi = c >> 4;
    const int q = min((c + (hi < 8 ? 7 : 8) - hi) >> 4, 15);
    if (p < 8) aw0 |= (uint32_t)q << (4 * p);
    else aw1 |= (uint32_t)q << (4 * (p - 8));
    const int d = c - q * 17;
    asum += d * d;                                  // exact in int and in f32
  }
  words[i] = make_uint4(aw0, aw1, cw0, cw1);
  err[i] = cerr + (float)asum;
}

bcx::Bc1Budget colour_budget(float w0, float w1, float w2, int iters, int passes,
                             int adaptive) {
  bcx::Bc1Budget bud;
  bud.w[0] = w0; bud.w[1] = w1; bud.w[2] = w2;
  bud.iters = iters; bud.passes = passes; bud.allow_three = 0;
  bud.use_alpha = 0; bud.athr255 = 0.0f; bud.adaptive = adaptive; bud.b3d = 0;
  return bud;
}

}  // namespace

// Both launch on `stream`, do not synchronise and return cudaGetLastError().
extern "C" int bc3_encode(const float* x, long long n, uint32_t* words, float* err, float w0,
                          float w1, float w2, int iters, int passes, int adaptive,
                          int a_iters, int a_radius, int a_rounds, void* stream) {
  if (int rc = bcx::check_args(x, 4)) return rc;
  bc3_kernel<<<bcx::grid_for(n), bcx::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, colour_budget(w0, w1, w2, iters, passes, adaptive), a_iters, a_radius, a_rounds,
      reinterpret_cast<uint4*>(words), err);
  return (int)cudaGetLastError();
}

extern "C" int bc2_encode(const float* x, long long n, uint32_t* words, float* err, float w0,
                          float w1, float w2, int iters, int passes, int adaptive,
                          void* stream) {
  if (int rc = bcx::check_args(x, 4)) return rc;
  bc2_kernel<<<bcx::grid_for(n), bcx::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, colour_budget(w0, w1, w2, iters, passes, adaptive),
      reinterpret_cast<uint4*>(words), err);
  return (int)cudaGetLastError();
}
