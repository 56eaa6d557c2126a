// BC1 kernel (K1a). Replaces the Pallas kernel
// gfx_imagecompress_tpu/kernels/bc1_pallas.py:_bc1_kernel (entry
// encode_bc1_blocks_pallas). The search is bc1_search.cuh's lane-group
// search; see there for what bounds it and what the design does about that.
//
// Launch shape: BC1_LANES (2) lanes per (block, mode), 32 blocks per CTA.
// With allow_three, a CTA of 128 threads: warps 0-1 run the 4-colour mode
// and warps 2-3 the 3-colour mode of the same 32 blocks; without it a CTA of
// 64 threads runs the 4-colour mode. The 4-colour group loads the block into
// shared memory; after both modes (a __syncthreads on each side) its lane 0
// races them and writes the block. With b3d, the cube takes the place of
// the refine and runs on the whole warp, its 16 (block, mode) groups one
// after the other. At most 128 registers (512 threads per SM). Eight
// instantiations: punch-through or not, three colours or not, the refine or
// the cube (b3d).
//
// (N,16,C>=3) float32 in [0,1] -> (N,2) uint32 words, (N,) float32 error.
#include "bc1_search.cuh"

namespace {

template <bool THREE>
struct Bc1Shape {
  enum {
    BLOCKS = bcx::BC1_CTA_BLOCKS,                 // blocks per CTA
    GROUPS = THREE ? 2 * BLOCKS : BLOCKS,         // (block, mode) groups
    THREADS = GROUPS * bcx::BC1_LANES,            // threads per CTA
  };
};

// One mode of group g (block j): start, the refine or the warp's cube, the
// final assign.
template <bool FOUR, bool MASKED, bool B3D, class Run>
__device__ __forceinline__ void fit_mode(bcx::Bc1Block* blk, bcx::Bc1Fit* fit,
                                         bcx::Bc1Cube* cube, int g, int j, int blocks,
                                         const bcx::Bc1Budget& bud, Run&& run) {
  bcx::bc1_group_start<FOUR, MASKED>(blk[j], fit[g], bud, run);
  if constexpr (B3D) {
    constexpr int W = 32 / bcx::BC1_LANES;          // groups per warp
    static_assert(bcx::BC1_CUBE_LANES == 32, "the cube runs on a whole warp");
    const int warp = threadIdx.x / 32;
    auto run32 = [&](auto&& f) {
      f((int)(threadIdx.x % 32));
      __syncwarp();
    };
#pragma unroll 1
    for (int k = 0; k < W; ++k) {
      const int gk = warp * W + k;
      bcx::bc1_cube<FOUR, MASKED>(blk[gk % blocks], fit[gk], bud, cube[warp], run32);
    }
  } else {
    bcx::bc1_group_refine<FOUR, MASKED>(blk[j], fit[g], bud, run);
  }
  bcx::bc1_group_assign<FOUR, MASKED>(blk[j], fit[g], run);
}

template <bool MASKED, bool THREE, bool B3D>
__global__ void __launch_bounds__(Bc1Shape<THREE>::THREADS, 512 / Bc1Shape<THREE>::THREADS)
bc1_kernel(const float* __restrict__ x, int64_t n, int C, bcx::Bc1Budget bud,
           uint2* __restrict__ words, float* __restrict__ err) {
  using Sh = Bc1Shape<THREE>;
  constexpr int L = bcx::BC1_LANES, B = Sh::BLOCKS;
  static_assert(32 % L == 0 && (B * L) % 32 == 0, "a mode's warps hold whole groups");
  __shared__ bcx::Bc1Block blk[B];
  __shared__ bcx::Bc1Fit fit[Sh::GROUPS];
  const int g = threadIdx.x / L, lane = threadIdx.x % L;
  const int mode = (THREE && g >= B) ? 1 : 0;       // 0: 4 colours, 1: 3 colours
  const int j = g - mode * B;                       // the block within the CTA
  const int64_t i = (int64_t)blockIdx.x * B + j;
  const bool valid = i < n;
  // A group past the last block encodes the last block once more and writes
  // nothing, so that every group of a warp runs the same phases and the
  // barrier is the whole warp's (a constant mask, no convergence check).
  const int64_t ie = valid ? i : n - 1;
  bcx::Bc1Lane regs;
  auto run = [&](auto&& f) {
    f(lane, regs);
    __syncwarp();
  };
  if (mode == 0) bcx::bc1_group_load<MASKED>(blk[j], x + ie * 16 * C, C, bud, run);
  __syncthreads();
  bcx::Bc1Cube* cube = nullptr;                     // the cube's scratch, one per warp
  if constexpr (B3D) {
    __shared__ bcx::Bc1Cube cubes[Sh::THREADS / 32];
    cube = cubes;
  }
  if (mode == 0) fit_mode<true, MASKED, B3D>(blk, fit, cube, g, j, B, bud, run);
  else fit_mode<false, MASKED, B3D>(blk, fit, cube, g, j, B, bud, run);
  __syncthreads();
  if (valid && mode == 0 && lane == 0) {
    uint2 w;
    float e;
    bcx::bc1_group_race<MASKED>(blk[j], fit[g], THREE ? &fit[g + B] : nullptr, w, e);
    words[i] = w;
    err[i] = e;
  }
}

template <bool MASKED, bool THREE, bool B3D>
void launch_shape(const float* x, long long n, int C, const bcx::Bc1Budget& bud, uint2* out,
                  float* err, cudaStream_t s) {
  using Sh = Bc1Shape<THREE>;
  const unsigned grid = (unsigned)((n + Sh::BLOCKS - 1) / Sh::BLOCKS);
  bc1_kernel<MASKED, THREE, B3D><<<grid, Sh::THREADS, 0, s>>>(x, n, C, bud, out, err);
}

template <bool MASKED, bool THREE>
void launch(const float* x, long long n, int C, const bcx::Bc1Budget& bud, uint2* out,
            float* err, cudaStream_t s) {
  if (bud.b3d) launch_shape<MASKED, THREE, true>(x, n, C, bud, out, err, s);
  else launch_shape<MASKED, THREE, false>(x, n, C, bud, out, err, s);
}

}  // namespace

// Launches on `stream`, does not synchronise; returns cudaGetLastError().
// use_alpha needs C >= 4.
extern "C" int bc1_encode(const float* x, long long n, int C, uint32_t* words, float* err,
                          float w0, float w1, float w2, int iters, int passes,
                          int allow_three, int use_alpha, float athr255, int adaptive,
                          int b3d, void* stream) {
  if (int rc = bcx::check_args(x, C)) return rc;
  if (C < 3 || (use_alpha && C < 4)) return (int)cudaErrorInvalidValue;
  bcx::Bc1Budget bud;
  bud.w[0] = w0; bud.w[1] = w1; bud.w[2] = w2;
  bud.iters = iters; bud.passes = passes; bud.allow_three = allow_three;
  bud.use_alpha = use_alpha; bud.athr255 = athr255; bud.adaptive = adaptive; bud.b3d = b3d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint2* out = reinterpret_cast<uint2*>(words);
  if (use_alpha) {
    if (allow_three) launch<true, true>(x, n, C, bud, out, err, s);
    else launch<true, false>(x, n, C, bud, out, err, s);
  } else {
    if (allow_three) launch<false, true>(x, n, C, bud, out, err, s);
    else launch<false, false>(x, n, C, bud, out, err, s);
  }
  return (int)cudaGetLastError();
}
