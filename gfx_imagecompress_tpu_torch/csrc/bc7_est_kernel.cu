// BC7 partition shortlist kernel (K3). Replaces the Pallas kernel
// gfx_imagecompress_tpu/kernels/bc7_full_pallas.py:_est_kernel (entry
// _estimate_topk_rows). The search is bc7_est.cuh; see there for what bounds
// it and what the design does about that. Channels, subsets, levels, k, the
// estimator and the partition list are launch arguments; the list travels
// in the kernel's parameter space, which is constant memory. k picks one of
// three instantiations by its slot count (bc7::slots_for).
//
// (N,16,4) float32 in [0,1] -> (N,k) int32 partition ids, best first.
#include "bc7_est.cuh"

namespace {

template <int NC, int K>
__global__ void __launch_bounds__(bcx::THREADS)
bc7_est_kernel(const float* __restrict__ x, int64_t n, int subsets, bc7::PartList pl,
               int levels, int k, int pca, int* __restrict__ ids) {
  const int64_t i = bcx::block_index();
  if (i >= n) return;
  float xs[NC][16];
  bcx::load_block<NC>(x + i * 64, 4, xs);
  bc7::estimate_topk<NC, K>(xs, subsets, pl, levels, k, pca != 0, ids + i * k);
}

}  // namespace

// Launches on `stream`, does not synchronise; returns cudaGetLastError().
// plist is a host array of nplist partition ids.
extern "C" int bc7_est_topk(const float* x, long long n, int chans, int subsets,
                            const int* plist, int nplist, int levels, int k, int pca,
                            int* ids, void* stream) {
  if (int rc = bcx::check_args(x, 4)) return rc;
  if ((chans != 3 && chans != 4) || (subsets != 2 && subsets != 3) || nplist < 1 ||
      nplist > 64 || levels < 2 || k < 1 || k > bc7::MAX_K || k > nplist)
    return (int)cudaErrorInvalidValue;
  bc7::PartList pl;
  pl.n = nplist;
  for (int j = 0; j < 64; ++j) {
    const int id = j < nplist ? plist[j] : 0;
    if (id < 0 || id > 63) return (int)cudaErrorInvalidValue;
    pl.id[j] = (uint8_t)id;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = bcx::grid_for(n);
  const int slots = bc7::slots_for(k);
#define BC7_EST_LAUNCH(NC, K)                                                          \
  bc7_est_kernel<NC, K><<<grid, bcx::THREADS, 0, s>>>(x, n, subsets, pl, levels, k, pca, ids)
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
