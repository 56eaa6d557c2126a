// The fast BC7 kernel (K4) at SWEEP_LANES lanes per block, a number given at
// build time (-DSWEEP_LANES=n): the lane sweep of
// scripts/torch_bc6h_bc7fast_timing.py (--lanes). The same C function as
// gfx_imagecompress_tpu_torch/csrc/bc7_fast_kernel.cu, which launches
// bc7::FAST_LANES lanes per block; only the launch shape differs.
#include "bc7_fast_search.cuh"

extern "C" int bc7_fast_encode(const float* x, long long n, const int* ids, int nids,
                               int perceptual, int uber, uint32_t* words, float* err,
                               void* stream) {
  return bc7::launch_fast<SWEEP_LANES>(x, n, ids, nids, perceptual, uber, words, err, stream);
}
