// The BC4 and BC5 kernels (K2a, K2b) at SWEEP_LANES lanes per block and
// family and SWEEP_THREADS threads per CTA (default 128), numbers given at
// build time (-DSWEEP_LANES=n -DSWEEP_THREADS=t): the launch-shape sweep of
// scripts/torch_bc1_est_timing.py (--lanes). The same C functions as
// gfx_imagecompress_tpu_torch/csrc/bc45_kernels.cu, which launches
// bcx::BC45_LANES; only the launch shape differs.
#include "bc45_group.cuh"

#ifndef SWEEP_THREADS
#define SWEEP_THREADS 128
#endif

extern "C" int bc4_encode(const float* x, long long n, uint32_t* words, float* err, int iters,
                          int radius, int rounds, void* stream) {
  return bcx::launch_bc4<SWEEP_LANES, SWEEP_THREADS>(x, n, words, err, iters, radius, rounds,
                                                     stream);
}

extern "C" int bc5_encode(const float* x, long long n, int C, uint32_t* words, float* err,
                          int iters, int radius, int rounds, void* stream) {
  return bcx::launch_bc5<SWEEP_LANES, SWEEP_THREADS>(x, n, C, words, err, iters, radius, rounds,
                                                     stream);
}
