// BC1 kernel (K1a). Replaces the Pallas kernel
// gfx_imagecompress_tpu/kernels/bc1_pallas.py:_bc1_kernel (entry
// encode_bc1_blocks_pallas). The search is bc1_search.cuh; see there for what
// bounds it and what the design does about that. Two instantiations: the
// punch-through one carries the 16 mask floats, the opaque one does not.
//
// (N,16,C>=3) float32 in [0,1] -> (N,2) uint32 words, (N,) float32 error.
#include "bc1_search.cuh"

namespace {

template <bool MASKED>
__global__ void __launch_bounds__(bcx::THREADS)
bc1_kernel(const float* __restrict__ x, int64_t n, int C, bcx::Bc1Budget bud,
           uint2* __restrict__ words, float* __restrict__ err) {
  const int64_t i = bcx::block_index();
  if (i >= n) return;
  const float* px = x + i * 16 * C;
  float xs[3][16];
  float m[16];
  if (MASKED) {
    float rgba[4][16];
    bcx::load_block<4>(px, C, rgba);
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      xs[0][p] = rgba[0][p];
      xs[1][p] = rgba[1][p];
      xs[2][p] = rgba[2][p];
      m[p] = (rgba[3][p] >= bud.athr255) ? 1.0f : 0.0f;
    }
  } else {
    bcx::load_block<3>(px, C, xs);
#pragma unroll
    for (int p = 0; p < 16; ++p) m[p] = 1.0f;
  }
  uint32_t a0, a1, pidx;
  float e;
  bcx::bc1_search<MASKED>(xs, m, bud, a0, a1, pidx, e);
  words[i] = make_uint2(a0 | (a1 << 16), pidx);
  err[i] = e;
}

}  // namespace

// Launches on `stream`, does not synchronise; returns cudaGetLastError().
// use_alpha needs C >= 4.
extern "C" int bc1_encode(const float* x, long long n, int C, uint32_t* words, float* err,
                          float w0, float w1, float w2, int iters, int passes,
                          int allow_three, int use_alpha, float athr255, int adaptive,
                          int b3d, void* stream) {
  if (int rc = bcx::check_args(x, C)) return rc;
  if (C < 3 || (use_alpha && C < 4)) return (int)cudaErrorInvalidValue;
  bcx::Bc1Budget bud;
  bud.w[0] = w0; bud.w[1] = w1; bud.w[2] = w2;
  bud.iters = iters; bud.passes = passes; bud.allow_three = allow_three;
  bud.use_alpha = use_alpha; bud.athr255 = athr255; bud.adaptive = adaptive; bud.b3d = b3d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint2* out = reinterpret_cast<uint2*>(words);
  if (use_alpha)
    bc1_kernel<true><<<bcx::grid_for(n), bcx::THREADS, 0, s>>>(x, n, C, bud, out, err);
  else
    bc1_kernel<false><<<bcx::grid_for(n), bcx::THREADS, 0, s>>>(x, n, C, bud, out, err);
  return (int)cudaGetLastError();
}
