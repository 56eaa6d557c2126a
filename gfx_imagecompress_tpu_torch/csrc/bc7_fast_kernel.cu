// Fast BC7 kernel (K4). Replaces the Pallas kernel
// gfx_imagecompress_tpu/kernels/bc7_fast_pallas.py:_bc7fast_kernel (entry
// encode_bc7_fast_blocks_pallas). The search is bc7_fast_search.cuh; see there
// for what bounds it and what the design does about that. The partition ids
// come from the shortlist kernel (bc7_est_kernel.cu); the single-colour
// endpoints are a table read inside the search, so nothing else crosses
// device memory. The metric is a template argument, the uber level a launch
// argument.
//
// (N,16,4) float32 in [0,1], (N,K) int32 ids -> (N,4) uint32 words,
// (N,) float32 error in metric units.
#include "bc7_fast_search.cuh"

// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int bc7_fast_encode(const float* x, long long n, const int* ids, int nids,
                               int perceptual, int uber, uint32_t* words, float* err,
                               void* stream) {
  return bc7::launch_fast<bc7::FAST_LANES>(x, n, ids, nids, perceptual, uber, words, err,
                                           stream);
}
