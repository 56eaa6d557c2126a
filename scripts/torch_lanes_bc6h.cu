// The BC6H kernel (K6) at SWEEP_LANES lanes per block, a number given at
// build time (-DSWEEP_LANES=n): the lane sweep of
// scripts/torch_bc6h_bc7fast_timing.py (--lanes). The same C function as
// gfx_imagecompress_tpu_torch/csrc/bc6h_kernel.cu, which launches bc6h::LANES
// lanes per block; only the launch shape differs.
#include "bc6h_search.cuh"

extern "C" int bc6h_encode(const int* h, long long n, int sg, int topk, int iters, int shake,
                           int mode_mask, int fb, uint32_t* words, float* err, void* stream) {
  return bc6h::launch<SWEEP_LANES>(h, n, sg, topk, iters, shake, mode_mask, fb, words, err,
                                   stream);
}
