// Full BC7 kernel (K5), the dual-index modes 4 and 5. Replaces the Pallas kernel
// gfx_imagecompress_tpu/kernels/bc7_full_pallas.py:_mode_kernel (entry
// encode_bc7_blocks_pallas), one launch per mode. The search is
// bc7_full_search.cuh; see there for what bounds it and what the design does
// about that. The modes are split over three sources so that their nvcc runs
// go side by side.
//
// (N,16,4) float32 in [0,1], (N,K) int32 ids (or none: partitions 0..K-1),
// (N,) bar bytes for modes 6/7 -> (N,4) uint32 words, (N,) float32 error,
// written or merged into a running best where the error is strictly smaller.
#include "bc7_full_search.cuh"

// Launches the kernel of `mode` on `stream`, does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a mode of another source.
extern "C" int bc7_full_m45(const float* x, long long n, int mode, const int* ids, int nids, int iters,
                            int shake, int uber, int keep, const uint8_t* bar, int merge, uint32_t* words,
                            float* err, void* stream) {
  switch (mode) {
    case 4:
      return bc7::launch_full<4>(x, n, ids, nids, iters, shake, uber, keep, bar, merge,
                                  words, err, stream);
    case 5:
      return bc7::launch_full<5>(x, n, ids, nids, iters, shake, uber, keep, bar, merge,
                                  words, err, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
