// BC7 partition shortlist kernel (K3). Replaces the Pallas kernel
// gfx_imagecompress_tpu/kernels/bc7_full_pallas.py:_est_kernel (entry
// _estimate_topk_rows). The search is bc7_est.cuh; see there for what bounds
// it and what the design does about that. Channels, subsets, levels, k, the
// estimator, the partition list and an optional per-block bar are launch
// arguments; the list travels in the kernel's parameter space, which is
// constant memory. The channels, the subsets and k's slot count
// (bc7::slots_for) pick one of twelve instantiations.
//
// Launch shape: 128 threads per CTA, 8 lanes per block (16 blocks per CTA);
// group `grp` of the CTA ranks block blockIdx.x * 16 + grp; the barrier
// between phases is the warp's (__syncwarp), every group of a warp running
// the same phases.
//
// (N,16,4) float32 in [0,1] -> (N,k) int32 partition ids, best first.
#include "bc7_est.cuh"

namespace {

template <int NC, int K, int S>
__global__ void __launch_bounds__(bc7::EST_THREADS)
bc7_est_kernel(const float* __restrict__ x, int64_t n, bc7::PartList pl, int levels, int k,
               int pca, const uint8_t* __restrict__ bar, int* __restrict__ ids) {
  constexpr int L = bc7::EST_LANES, B = bc7::EST_BLOCKS;
  static_assert(32 % L == 0, "a group lies inside one warp");
  __shared__ bc7::EstShared<K> sh[B];
  const int grp = threadIdx.x / L, lane = threadIdx.x % L;
  const int64_t i = (int64_t)blockIdx.x * B + grp;
  // A group past the last block takes the bar's path without writing, so
  // that every group of a warp runs the same phases and the barrier is the
  // whole warp's (a constant mask, no convergence check).
  const bool valid = i < n;
  bc7::est_block<NC, K, S>(sh[grp], x + (valid ? i : 0) * 64,
                           !valid || (bar != nullptr && bar[i]), pl, levels, k, pca != 0,
                           valid ? ids + i * k : nullptr, [&](auto&& f) {
                             f(lane);
                             __syncwarp();
                           });
}

template <int NC, int K>
void launch(const float* x, long long n, int subsets, const bc7::PartList& pl, int levels,
            int k, int pca, const uint8_t* bar, int* ids, cudaStream_t s) {
  const unsigned grid = (unsigned)((n + bc7::EST_BLOCKS - 1) / bc7::EST_BLOCKS);
  if (subsets == 2)
    bc7_est_kernel<NC, K, 2><<<grid, bc7::EST_THREADS, 0, s>>>(x, n, pl, levels, k, pca, bar, ids);
  else
    bc7_est_kernel<NC, K, 3><<<grid, bc7::EST_THREADS, 0, s>>>(x, n, pl, levels, k, pca, bar, ids);
}

}  // namespace

// Launches on `stream`, does not synchronise; returns cudaGetLastError().
// plist is a host array of nplist partition ids, deal a host array of the
// nplist list positions in the order they are dealt to the lanes (any
// permutation gives the same ids); bar is null or an (n,) device array of
// bools (a set entry: the list's first k ids).
extern "C" int bc7_est_topk(const float* x, long long n, int chans, int subsets,
                            const int* plist, const int* deal, int nplist, int levels, int k,
                            int pca, const uint8_t* bar, int* ids, void* stream) {
  if (int rc = bcx::check_args(x, 4)) return rc;
  if ((chans != 3 && chans != 4) || (subsets != 2 && subsets != 3) || nplist < 1 ||
      nplist > 64 || levels < 2 || k < 1 || k > bc7::MAX_K || k > nplist)
    return (int)cudaErrorInvalidValue;
  bc7::PartList pl;
  pl.n = nplist;
  uint64_t dealt = 0;
  for (int j = 0; j < 64; ++j) {
    const int id = j < nplist ? plist[j] : 0;
    const int pos = j < nplist ? deal[j] : 0;
    if (id < 0 || id > 63 || pos < 0 || pos >= nplist || (j < nplist && (dealt >> pos) & 1))
      return (int)cudaErrorInvalidValue;
    if (j < nplist) dealt |= 1ull << pos;
    pl.id[j] = (uint8_t)id;
    pl.deal[j] = (uint8_t)pos;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slots = bc7::slots_for(k);
#define BC7_EST_LAUNCH(NC, K) launch<NC, K>(x, n, subsets, pl, levels, k, pca, bar, ids, s)
  if (chans == 3) {
    if (slots == 4)
      BC7_EST_LAUNCH(3, 4);
    else if (slots == 9)
      BC7_EST_LAUNCH(3, 9);
    else
      BC7_EST_LAUNCH(3, 16);
  } else {
    if (slots == 4)
      BC7_EST_LAUNCH(4, 4);
    else if (slots == 9)
      BC7_EST_LAUNCH(4, 9);
    else
      BC7_EST_LAUNCH(4, 16);
  }
#undef BC7_EST_LAUNCH
  return (int)cudaGetLastError();
}
