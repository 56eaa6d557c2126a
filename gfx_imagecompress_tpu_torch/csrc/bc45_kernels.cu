// BC4 kernel (K2a) and BC5 kernel (K2b). Replace the Pallas kernels
// gfx_imagecompress_tpu/kernels/bc4_pallas.py:_bc4_kernel and :_bc5_kernel
// (entries encode_bc4_blocks_pallas, encode_bc5_blocks_pallas). Both are thin
// over bc4_search.cuh: BC4 runs it once, BC5 on channel 0 and then channel 1
// of the same block in one launch. Bound: operations (see the header).
//
// BC4: (N,16) float32 in [0,1] -> (N,2) uint32 words, (N,) float32 error.
// BC5: (N,16,C>=2) float32     -> (N,4) uint32 words, (N,) float32 error.
#include "bc4_search.cuh"

namespace {

__global__ void __launch_bounds__(bcx::THREADS)
bc4_kernel(const float* __restrict__ x, int64_t n, int iters, int radius, int rounds,
           uint2* __restrict__ words, float* __restrict__ err) {
  const int64_t i = bcx::block_index();
  if (i >= n) return;
  float vals[1][16];
  {
    // 16 contiguous floats: four 16-byte loads
    const float4* p4 = reinterpret_cast<const float4*>(x + i * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = p4[q];
      vals[0][4 * q + 0] = v.x * 255.0f;
      vals[0][4 * q + 1] = v.y * 255.0f;
      vals[0][4 * q + 2] = v.z * 255.0f;
      vals[0][4 * q + 3] = v.w * 255.0f;
    }
  }
  int a0, a1, idx[16];
  float e;
  bcx::bc4_search(vals[0], iters, radius, rounds, a0, a1, idx, e);
  uint32_t w0, w1;
  bcx::pack_dxt5(a0, a1, idx, w0, w1);
  words[i] = make_uint2(w0, w1);
  err[i] = e;
}

__global__ void __launch_bounds__(bcx::THREADS)
bc5_kernel(const float* __restrict__ x, int64_t n, int C, int iters, int radius, int rounds,
           uint4* __restrict__ words, float* __restrict__ err) {
  const int64_t i = bcx::block_index();
  if (i >= n) return;
  float rg[2][16];
  bcx::load_block<2>(x + i * 16 * C, C, rg);
  int a0, a1, idx[16];
  float er, eg;
  uint32_t w0, w1, w2, w3;
  bcx::bc4_search(rg[0], iters, radius, rounds, a0, a1, idx, er);
  bcx::pack_dxt5(a0, a1, idx, w0, w1);
  bcx::bc4_search(rg[1], iters, radius, rounds, a0, a1, idx, eg);
  bcx::pack_dxt5(a0, a1, idx, w2, w3);
  words[i] = make_uint4(w0, w1, w2, w3);
  err[i] = er + eg;
}

}  // namespace

// Both launch on `stream`, do not synchronise and return cudaGetLastError().
extern "C" int bc4_encode(const float* x, long long n, uint32_t* words, float* err, int iters,
                          int radius, int rounds, void* stream) {
  if (int rc = bcx::check_args(x, 4)) return rc;
  bc4_kernel<<<bcx::grid_for(n), bcx::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, iters, radius, rounds, reinterpret_cast<uint2*>(words), err);
  return (int)cudaGetLastError();
}

extern "C" int bc5_encode(const float* x, long long n, int C, uint32_t* words, float* err,
                          int iters, int radius, int rounds, void* stream) {
  if (int rc = bcx::check_args(x, C)) return rc;
  if (C < 2) return (int)cudaErrorInvalidValue;
  bc5_kernel<<<bcx::grid_for(n), bcx::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, C, iters, radius, rounds, reinterpret_cast<uint4*>(words), err);
  return (int)cudaGetLastError();
}
