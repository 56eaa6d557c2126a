// Shared by the kernel sources: launch shape, pixel loads, argument check.
//
// In the kernel that launches with THREADS and block_index (K1c; in the
// others a group of lanes shares a block: bc1_search.cuh, bc23_group.cuh,
// bc45_group.cuh, bc7_est.cuh, bc7_fast_search.cuh, bc7_full_search.cuh,
// bc6h_search.cuh), one thread encodes one 4x4 block; 128 threads per CTA.
// A thread reads its
// 16 pixels straight from the (N,16,C) tensor image_to_blocks() produced -
// 16-byte loads for RGBA - rather than from a channel-major transpose: the
// searches are bound by operations, not bytes, every byte of each cache line
// a warp touches is used, and a transpose would cost a second pass over the
// image in device memory.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace bcx {

constexpr int THREADS = 128;

__device__ __forceinline__ int64_t block_index() {
  return (int64_t)blockIdx.x * THREADS + threadIdx.x;
}

// int -> float, exactly (float)v for |v| < 2^22: the integer added into the
// mantissa of 1.5 * 2^23, then that constant subtracted. Two full-rate
// instructions where a conversion issues at 16 per SM and clock on compute
// capability 9.0 (a float add at 128: the CUDA programming guide's throughput
// table); the searches convert in their pixel loops (palette entries, levels,
// decoded values).
__device__ __forceinline__ float i2f(int v) {
  return __int_as_float(v + 0x4B400000) - 12582912.0f;
}

__device__ __forceinline__ int clamp_i(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

inline unsigned grid_for(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

// Load channels [0, NCH) of one block, scaled to 0..255, from a tensor with C
// floats per pixel.
template <int NCH>
__device__ __forceinline__ void load_block(const float* __restrict__ px, int C,
                                           float (&out)[NCH][16]) {
  if (C == 4) {
    const float4* p4 = reinterpret_cast<const float4*>(px);
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const float4 v = p4[p];
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < NCH; ++c) out[c][p] = f[c] * 255.0f;
    }
  } else {
#pragma unroll
    for (int p = 0; p < 16; ++p) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) out[c][p] = px[p * C + c] * 255.0f;
    }
  }
}

// A tensor of 4-channel pixels is read as float4: its base must be 16-byte
// aligned. Returns a CUDA error code (0 = fine).
inline int check_args(const void* x, int C) {
  if (C == 4 && (reinterpret_cast<uintptr_t>(x) & 15u)) return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace bcx
