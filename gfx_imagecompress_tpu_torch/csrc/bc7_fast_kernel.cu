// Fast BC7 kernel (K4). Replaces the Pallas kernel
// gfx_imagecompress_tpu/kernels/bc7_fast_pallas.py:_bc7fast_kernel (entry
// encode_bc7_fast_blocks_pallas). The search is bc7_fast_search.cuh; see there
// for what bounds it and what the design does about that. The partition ids
// come from the shortlist kernel (bc7_est_kernel.cu); the single-colour
// endpoints are a table read inside the search, so nothing else crosses
// device memory. The metric and the uber level are launch arguments.
//
// (N,16,4) float32 in [0,1], (N,K) int32 ids -> (N,4) uint32 words,
// (N,) float32 error in metric units.
#include "bc7_fast_search.cuh"

namespace {

__global__ void __launch_bounds__(bcx::THREADS)
bc7_fast_kernel(const float* __restrict__ x, int64_t n, const int* __restrict__ ids, int nids,
                int perceptual, int uber, uint4* __restrict__ words,
                float* __restrict__ err) {
  const int64_t i = bcx::block_index();
  if (i >= n) return;
  const float4* p4 = reinterpret_cast<const float4*>(x + i * 64);
  float xs[4][16];
  float raw[3];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const float4 v = p4[p];
    xs[0][p] = v.x * 255.0f;
    xs[1][p] = v.y * 255.0f;
    xs[2][p] = v.z * 255.0f;
    xs[3][p] = v.w * 255.0f;
    raw[0] = p ? raw[0] + v.x : v.x;
    raw[1] = p ? raw[1] + v.y : v.y;
    raw[2] = p ? raw[2] + v.z : v.z;
  }
  bc7::Bits128 out;
  float e;
  bc7::fast_search(xs, raw, ids + i * nids, nids, perceptual != 0, uber, out, e);
  words[i] = make_uint4((uint32_t)out.lo, (uint32_t)(out.lo >> 32), (uint32_t)out.hi,
                        (uint32_t)(out.hi >> 32));
  err[i] = e;
}

}  // namespace

// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int bc7_fast_encode(const float* x, long long n, const int* ids, int nids,
                               int perceptual, int uber, uint32_t* words, float* err,
                               void* stream) {
  if (int rc = bcx::check_args(x, 4)) return rc;
  if (nids < 1 || uber < 0) return (int)cudaErrorInvalidValue;
  bc7_fast_kernel<<<bcx::grid_for(n), bcx::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, n, ids, nids, perceptual, uber, reinterpret_cast<uint4*>(words), err);
  return (int)cudaGetLastError();
}
