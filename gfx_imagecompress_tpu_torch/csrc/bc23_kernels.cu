// BC3 kernel (K1b) and BC2 kernel (K1c). Replace the Pallas kernels
// gfx_imagecompress_tpu/kernels/bc1_pallas.py:_bc3_kernel and :_bc2_kernel
// (entries encode_bc3_blocks_pallas, encode_bc2_blocks_pallas). The phases,
// the kernels and their launch shapes are bc23_group.cuh; see there for what
// bounds them and what the designs do about that. One launch does both
// halves of a block from one load.
//
// (N,16,4) float32 in [0,1] -> (N,4) uint32 words, (N,) float32 error.
#include "bc23_group.cuh"

// Both launch on `stream`, do not synchronise and return cudaGetLastError().
extern "C" int bc3_encode(const float* x, long long n, uint32_t* words, float* err, float w0,
                          float w1, float w2, int iters, int passes, int adaptive,
                          int a_iters, int a_radius, int a_rounds, void* stream) {
  return bcx::launch_bc3(
      x, n, bcx::bc23_budget(w0, w1, w2, iters, passes, adaptive), a_iters, a_radius,
      a_rounds, words, err, stream);
}

extern "C" int bc2_encode(const float* x, long long n, uint32_t* words, float* err, float w0,
                          float w1, float w2, int iters, int passes, int adaptive,
                          void* stream) {
  return bcx::launch_bc2(
      x, n, bcx::bc23_budget(w0, w1, w2, iters, passes, adaptive), words, err, stream);
}
