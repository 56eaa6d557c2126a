// BC6H kernel (K6), signed and unsigned. Replaces the Pallas kernel
// gfx_imagecompress_tpu/kernels/bc6h_pallas.py:_bc6h_kernel (entry
// encode_bc6h_blocks_pallas). The search is bc6h_search.cuh; see there for
// what bounds it and what the design does about that.
//
// (N,16,3) int32 half-ints (kernels/bc6h.py f32_to_half_int) -> (N,4) uint32
// words, (N,) float32 squared error in half-int space.
#include "bc6h_search.cuh"

// Launches the kernel on `stream`, does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a budget, mode mask or
// fallback the kernel does not take (topk 1..32, iters >= 0, shake >= 0, a
// mode of 1..14, `fb` -1 or an enabled mode index: the solid-mean fallback).
extern "C" int bc6h_encode(const int* h, long long n, int sg, int topk, int iters, int shake,
                           int mode_mask, int fb, uint32_t* words, float* err, void* stream) {
  return bc6h::launch<bc6h::LANES>(h, n, sg, topk, iters, shake, mode_mask, fb, words, err,
                                   stream);
}
