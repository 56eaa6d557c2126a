// BC4 kernel (K2a) and BC5 kernel (K2b). Replace the Pallas kernels
// gfx_imagecompress_tpu/kernels/bc4_pallas.py:_bc4_kernel and :_bc5_kernel
// (entries encode_bc4_blocks_pallas, encode_bc5_blocks_pallas). The phases,
// the kernels and their launch shapes are bc45_group.cuh; see there for what
// bounds them and what the design does about that.
//
// BC4: (N,16) float32 in [0,1] -> (N,2) uint32 words, (N,) float32 error.
// BC5: (N,16,C>=2) float32     -> (N,4) uint32 words, (N,) float32 error.
#include "bc45_group.cuh"

// Both launch on `stream`, do not synchronise and return cudaGetLastError().
extern "C" int bc4_encode(const float* x, long long n, uint32_t* words, float* err, int iters,
                          int radius, int rounds, void* stream) {
  return bcx::launch_bc4<bcx::BC45_LANES>(x, n, words, err, iters, radius, rounds, stream);
}

extern "C" int bc5_encode(const float* x, long long n, int C, uint32_t* words, float* err,
                          int iters, int radius, int rounds, void* stream) {
  return bcx::launch_bc5<bcx::BC45_LANES>(x, n, C, words, err, iters, radius, rounds, stream);
}
