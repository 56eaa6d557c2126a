"""The BC7 CUDA searches, compiled for the host, against the plain versions.

``csrc/bc7_est.cuh``, ``csrc/bc7_fast_search.cuh`` and
``csrc/bc7_full_search.cuh`` are plain C++ apart from the CUDA keywords (the
full search's kernel and launcher sit behind ``__CUDACC__``), so ``g++`` builds
them against a small stub of ``cuda_runtime.h`` and a loop over blocks takes
the place of the launch. The shortlist, the fast search and the full search
are written as phases of a group of lanes over a shared struct; here each
phase runs as a loop over the lanes, so the host build runs the card's own
phase and scan code. That
puts the arithmetic of the kernels under test where there is no card: the same
numpy blocks go through the host build and through the plain PyTorch versions,
and the partition ids, the words and the errors must be equal on every block
(``-ffp-contract=off`` stands in for ``nvcc -fmad=false``; both sides divide,
round half to even and take correctly rounded square roots). The launch
itself, the loads and the resource use are still only checked on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``). For the full search this
is the only check of the kernel's arithmetic at the main path's budget
(quality 1.0) that runs where there is no card.
"""
import ctypes
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu_torch.kernels import bc7_est, bc7_fast, bc7_full
from gfx_imagecompress_tpu_torch.tables.bc7_tables import P2

from conftest import photo_rgba

CSRC = (Path(__file__).resolve().parent.parent
        / "gfx_imagecompress_tpu_torch" / "csrc")

STUB = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__ static const
#define __launch_bounds__(x)
inline int __ffs(int v) { return __builtin_ffs(v); }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct dim3s { unsigned x; };
static dim3s blockIdx, threadIdx;
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline float __int_as_float(int v) {
  float f;
  std::memcpy(&f, &v, sizeof f);
  return f;
}
using std::max;
using std::min;
enum { cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 716 };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return uint4{a, b, c, d};
}
inline uint2 make_uint2(unsigned a, unsigned b) { return uint2{a, b}; }
"""

HARNESS = r"""
#include "bc7_est.cuh"
#include "bc7_fast_search.cuh"
#include "bc7_full_search.cuh"

#include <cstring>

// With g_orders set, every phase runs twice from the same shared state: its
// lanes in descending order, then ascending. A phase in which one lane reads
// or writes what another lane writes in the same phase (a race between the
// card's lanes, which only the group's barrier orders) leaves two different
// states; g_races counts those phases.
static int g_orders = 0;
static long long g_races = 0;

// block i of the shortlist's kernel: each phase as a loop over the group's
// lanes (both orders with g_orders; the ids written count as state)
template <int NC, int K, int S>
static void est_shaped(const float* x, bool barred, const bc7::PartList& pl,
                       int levels, int k, int pca, int* ids) {
  using Sh = bc7::EstShared<K>;
  static Sh sh, before, down;
  static int ids_before[bc7::MAX_K], ids_down[bc7::MAX_K];
  constexpr int L = bc7::EST_LANES;
  bc7::est_block<NC, K, S>(sh, x, barred, pl, levels, k, pca != 0, ids,
                           [&](auto&& f) {
    if (g_orders) {
      std::memcpy(&before, &sh, sizeof(Sh));
      std::memcpy(ids_before, ids, k * sizeof(int));
      for (int lane = L - 1; lane >= 0; --lane) f(lane);
      std::memcpy(&down, &sh, sizeof(Sh));
      std::memcpy(ids_down, ids, k * sizeof(int));
      std::memcpy(&sh, &before, sizeof(Sh));
      std::memcpy(ids, ids_before, k * sizeof(int));
    }
    for (int lane = 0; lane < L; ++lane) f(lane);
    if (g_orders && (std::memcmp(&down, &sh, sizeof(Sh)) ||
                     std::memcmp(ids_down, ids, k * sizeof(int))))
      ++g_races;
  });
}

template <int NC, int S>
static void est_one(const float* x, bool barred, const bc7::PartList& pl,
                    int levels, int k, int pca, int* ids) {
  const int slots = bc7::slots_for(k);
  if (slots == 4)
    est_shaped<NC, 4, S>(x, barred, pl, levels, k, pca, ids);
  else if (slots == 9)
    est_shaped<NC, 9, S>(x, barred, pl, levels, k, pca, ids);
  else
    est_shaped<NC, 16, S>(x, barred, pl, levels, k, pca, ids);
}

// the shortlist's launch shape: lanes per block, threads per CTA
extern "C" void host_est_shape(int* out) {
  out[0] = bc7::EST_LANES;
  out[1] = bc7::EST_THREADS;
}

// bc7_est_topk's contract; with `orders`, every phase in both lane orders.
// Returns the number of phases whose two orders left different states.
extern "C" long long host_est(const float* x, long long n, int chans,
                              int subsets, const int* plist, const int* deal,
                              int nplist, int levels, int k, int pca,
                              const unsigned char* bar, int orders,
                              int* ids) {
  bc7::PartList pl;
  pl.n = nplist;
  for (int j = 0; j < 64; ++j) {
    pl.id[j] = j < nplist ? plist[j] : 0;
    pl.deal[j] = j < nplist ? deal[j] : 0;
  }
  g_orders = orders;
  g_races = 0;
  for (long long i = 0; i < n; ++i) {
    const bool barred = bar != nullptr && bar[i];
    const float* xi = x + i * 64;
    int* out = ids + i * k;
    if (chans == 3 && subsets == 2)
      est_one<3, 2>(xi, barred, pl, levels, k, pca, out);
    else if (chans == 3)
      est_one<3, 3>(xi, barred, pl, levels, k, pca, out);
    else if (subsets == 2)
      est_one<4, 2>(xi, barred, pl, levels, k, pca, out);
    else
      est_one<4, 3>(xi, barred, pl, levels, k, pca, out);
  }
  g_orders = 0;
  return g_races;
}

// block i of the full search's kernel of mode M in shape W: each phase as a
// loop over the group's lanes
template <int M, int W>
static void host_shaped(const float* x, long long i, const int* ids, int nids,
                        int iters, int shake, int uber, int keep,
                        const unsigned char* bar, int merge, uint4* w,
                        float* err) {
  using Sh = typename bc7::SharedOf<M, W>::type;
  static Sh sh, before, down;
  constexpr int L = bc7::Shape<M, W>::LANES;
  bc7::full_block<M, W>(sh, x, i, ids, nids, iters, shake, uber, keep, bar,
                        merge, w, err, [](auto&& f) {
                       if (g_orders) {
                         std::memcpy(&before, &sh, sizeof(Sh));
                         for (int lane = L - 1; lane >= 0; --lane) f(lane);
                         std::memcpy(&down, &sh, sizeof(Sh));
                         std::memcpy(&sh, &before, sizeof(Sh));
                       }
                       for (int lane = 0; lane < L; ++lane) f(lane);
                       if (g_orders && std::memcmp(&down, &sh, sizeof(Sh)))
                         ++g_races;
                     });
}

// the shape the launcher picks for the budget
template <int M>
static void host_block(const float* x, long long i, const int* ids, int nids,
                       int iters, int shake, int uber, int keep,
                       const unsigned char* bar, int merge, uint4* w,
                       float* err) {
  if constexpr (bc7::Shape<M>::DUAL)
    host_shaped<M, 0>(x, i, ids, nids, iters, shake, uber, keep, bar, merge,
                      w, err);
  else if (bc7::narrow_shape<M>(shake, uber))
    host_shaped<M, 1>(x, i, ids, nids, iters, shake, uber, keep, bar, merge,
                      w, err);
  else
    host_shaped<M, 0>(x, i, ids, nids, iters, shake, uber, keep, bar, merge,
                      w, err);
}

extern "C" void host_full(const float* x, long long n, int mode,
                          const int* ids, int nids, int iters, int shake,
                          int uber, int keep, const unsigned char* bar,
                          int merge, unsigned* words, float* err) {
  uint4* w = reinterpret_cast<uint4*>(words);
  for (long long i = 0; i < n; ++i) {
    switch (mode) {
#define HOST_FULL(M)                                                       \
  case M:                                                                  \
    host_block<M>(x, i, ids, nids, iters, shake, uber, keep, bar, merge,   \
                  w, err);                                                 \
    break;
      HOST_FULL(0) HOST_FULL(1) HOST_FULL(2) HOST_FULL(3)
      HOST_FULL(4) HOST_FULL(5) HOST_FULL(6) HOST_FULL(7)
#undef HOST_FULL
    }
  }
}

// host_full with every phase run in both lane orders; returns the number of
// phases whose two orders left different shared states
extern "C" long long host_full_orders(const float* x, long long n, int mode,
                                      const int* ids, int nids, int iters,
                                      int shake, int uber, int keep,
                                      const unsigned char* bar, int merge,
                                      unsigned* words, float* err) {
  g_orders = 1;
  g_races = 0;
  host_full(x, n, mode, ids, nids, iters, shake, uber, keep, bar, merge,
            words, err);
  g_orders = 0;
  return g_races;
}

// the launch shapes of mode M's kernel: lanes per block and threads per CTA
// for a budget with refinement, then without; then whether the narrow kernel
// is launched without refinement, and with some
extern "C" void host_shape(int mode, int* out) {
  switch (mode) {
#define HOST_SHAPE(M)                                                  \
  case M:                                                              \
    out[0] = bc7::Shape<M>::LANES;                                     \
    out[1] = bc7::Shape<M>::THREADS;                                   \
    out[2] = bc7::Shape<M, 1>::LANES;                                  \
    out[3] = bc7::Shape<M, 1>::THREADS;                                \
    out[4] = bc7::narrow_shape<M>(0, 0);                               \
    out[5] = bc7::narrow_shape<M>(1, 0) || bc7::narrow_shape<M>(0, 1); \
    break;
    HOST_SHAPE(0) HOST_SHAPE(1) HOST_SHAPE(2) HOST_SHAPE(3)
    HOST_SHAPE(4) HOST_SHAPE(5) HOST_SHAPE(6) HOST_SHAPE(7)
#undef HOST_SHAPE
  }
}

// the keep-2 scan over errors e[0..n) as the search drives keep2_step:
// out[0] the best, out[1] the runner-up (-1: none)
extern "C" void host_keep2(const float* e, int n, int* out) {
  int b = 0, b2 = -1;
  for (int k = 1; k < n; ++k) {
    const int a = bc7::keep2_step(e[k], e[b], b2 >= 0 ? e[b2] : 0.0f, b2 >= 0);
    if (a & 2) b2 = (a & 1) ? b : k;
    if (a & 1) b = k;
  }
  out[0] = b;
  out[1] = b2;
}

// scan_min over e[0..n) against the incumbent `inc`, ok[t] == 0 skipped
extern "C" int host_scan_min(float inc, const float* e, const int* ok, int n) {
  return bc7::scan_min(inc, n, [&](int t) { return e[t]; },
                       [&](int t) { return ok[t] != 0; });
}

// block i of the fast search's kernel in the shape of L lanes: each phase as
// a loop over the lanes (both orders with g_orders); the group's struct is
// filled with 0xFF bytes first, so a phase that reads what no earlier phase
// of this block wrote reads NaNs and ids past the list
template <int L, bool PERC>
static void fast_shaped(const float* x, long long i, const int* ids, int nids,
                        int uber, uint4* w, float* err) {
  using Sh = bc7::FastShared<L>;
  static Sh sh, before, down;
  std::memset(&sh, 0xFF, sizeof(Sh));
  bc7::fast_block<L, PERC>(sh, x, i, ids, nids, uber, w, err, [](auto&& f) {
    if (g_orders) {
      std::memcpy(&before, &sh, sizeof(Sh));
      for (int lane = L - 1; lane >= 0; --lane) f(lane);
      std::memcpy(&down, &sh, sizeof(Sh));
      std::memcpy(&sh, &before, sizeof(Sh));
    }
    for (int lane = 0; lane < L; ++lane) f(lane);
    if (g_orders && std::memcmp(&down, &sh, sizeof(Sh))) ++g_races;
  });
}

// bc7_fast_encode's contract; with `orders`, every phase in both lane
// orders. Returns the number of phases whose two orders left different
// shared states.
extern "C" long long host_fast(const float* x, long long n, const int* ids,
                               int nids, int perceptual, int uber, int orders,
                               unsigned* words, float* err) {
  uint4* w = reinterpret_cast<uint4*>(words);
  g_orders = orders;
  g_races = 0;
  for (long long i = 0; i < n; ++i) {
    if (perceptual)
      fast_shaped<bc7::FAST_LANES, true>(x, i, ids, nids, uber, w, err);
    else
      fast_shaped<bc7::FAST_LANES, false>(x, i, ids, nids, uber, w, err);
  }
  g_orders = 0;
  return g_races;
}

// the fast search's launch shape: lanes per block, threads per CTA
extern "C" void host_fast_shape(int* out) {
  out[0] = bc7::FAST_LANES;
  out[1] = bc7::FastShape<bc7::FAST_LANES>::THREADS;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA search headers for the host")
    d = tmp_path_factory.mktemp("bc7_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libbc7_host.so"
    r = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math",
         "-Wno-unknown-pragmas", "-shared", "-fPIC", "-I", str(d), "-I",
         str(CSRC), "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_est.argtypes = [p, ll, i, i, p, p, i, i, i, i, p, i, p]
    lib.host_est.restype = ll
    lib.host_fast.argtypes = [p, ll, p, i, i, i, i, p, p]
    lib.host_fast.restype = ll
    lib.host_fast_shape.argtypes = [p]
    lib.host_fast_shape.restype = None
    lib.host_full.argtypes = [p, ll, i, p, i, i, i, i, i, p, i, p, p]
    lib.host_full.restype = None
    lib.host_full_orders.argtypes = lib.host_full.argtypes
    lib.host_full_orders.restype = ll
    lib.host_keep2.argtypes = [p, i, p]
    lib.host_keep2.restype = None
    lib.host_scan_min.argtypes = [ctypes.c_float, p, p, i]
    lib.host_scan_min.restype = i
    lib.host_shape.argtypes = [i, p]
    lib.host_shape.restype = None
    lib.host_est_shape.argtypes = [p]
    lib.host_est_shape.restype = None
    return lib


def _to_blocks(img):
    h, w, c = img.shape
    t = img.reshape(h // 4, 4, w // 4, 4, c).transpose(0, 2, 1, 3, 4)
    return t.reshape(-1, 16, c)


def _blocks():
    """768 blocks: photo, noise, solid, two-colour blocks split along shapes
    of every anchor class, exact 0/1 values, gradients; every other block is
    opaque so mode 1 meets every kind, the others carry alpha."""
    rng = np.random.default_rng(17)
    parts = [_to_blocks(photo_rgba(64, 64, seed=3)),                    # 256
             rng.random((128, 16, 4), np.float32),
             np.repeat(rng.random((64, 1, 4), np.float32), 16, 1)]
    for shape in (0, 13, 17, 18, 34, 47, 22, 60):                       # 128
        c = rng.random((16, 2, 4), np.float32)
        pick = np.array([(P2[shape] >> p) & 1 for p in range(16)])
        parts.append(c[:, pick, :] + rng.normal(0, 0.01, (16, 16, 4)))
    parts.append(rng.integers(0, 2, (64, 16, 4)).astype(np.float32))
    base = rng.integers(0, 255, (64, 1, 4))
    parts.append((base + rng.integers(0, 2, (64, 16, 1))) / 255.0)
    parts.append(np.linspace(0, 1, 16)[None, :, None]
                 * rng.random((64, 1, 4)) + rng.random((64, 1, 4)) * 0.5)
    x = np.clip(np.concatenate(parts), 0, 1).astype(np.float32)
    x[::2, :, 3] = 1.0
    assert x.shape == (768, 16, 4)
    return np.ascontiguousarray(x)


def _host_est(lib, x, chans, subsets, plist, levels, k, estimator="bounds",
              bar=None, orders=False, deal=None):
    """bc7_est_topk's contract through the host build, the partitions dealt
    as the wrapper deals them (or in the order ``deal``); with ``orders``
    every phase runs in both lane orders and a phase whose two orders differ
    fails."""
    pl = np.asarray(plist, np.int32)
    dl = np.asarray(bc7_est.deal_order(tuple(plist), subsets) if deal is None
                    else deal, np.int32)
    k = min(k, len(pl))
    ids = np.zeros((x.shape[0], k), np.int32)
    bar_np = None if bar is None else np.ascontiguousarray(bar, np.uint8)
    races = lib.host_est(x.ctypes.data, x.shape[0], chans, subsets,
                         pl.ctypes.data, dl.ctypes.data, len(pl), levels, k,
                         int(estimator == "pca"),
                         None if bar_np is None else bar_np.ctypes.data,
                         int(orders), ids.ctypes.data)
    assert races == 0, f"{races} shortlist phases depend on their lane order"
    return ids


EST_CASES = {
    "rgb_2sub_64_k4": dict(chans=3, subsets=2, plist=tuple(range(64)),
                           levels=8, k=4),
    "rgb_2sub_fast24_k2": dict(chans=3, subsets=2,
                               plist=bc7_fast.FAST_PARTITIONS, levels=8, k=2),
    "rgb_3sub_16_k4": dict(chans=3, subsets=3, plist=tuple(range(16)),
                           levels=4, k=4),
    "rgb_3sub_64_k1": dict(chans=3, subsets=3, plist=tuple(range(64)),
                           levels=4, k=1),
    "rgba_2sub_64_k8_pca": dict(chans=4, subsets=2, plist=tuple(range(64)),
                                levels=4, k=8, estimator="pca"),
    "rgba_2sub_bounds_k3": dict(chans=4, subsets=2, plist=(5, 40, 2, 63, 9),
                                levels=4, k=3),
    "rgb_2sub_64_k9": dict(chans=3, subsets=2, plist=tuple(range(64)),
                           levels=8, k=9),
    "rgb_3sub_16_k16": dict(chans=3, subsets=3, plist=tuple(range(16)),
                            levels=8, k=16),
}


@pytest.mark.parametrize(
    "name", [*EST_CASES, *(f"{n}_barred" for n in EST_CASES)])
def test_host_built_shortlist_equals_plain_version(host_lib, name):
    """The lane-group shortlist, each phase in both lane orders, against the
    plain version; ``_barred``: with a bar on every third block and on the
    fourth quarter, whose blocks get the list's first k ids on both sides."""
    x = _blocks()
    cfg = EST_CASES[name.removesuffix("_barred")]
    bar = None
    if name.endswith("_barred"):
        bar = np.zeros(x.shape[0], bool)
        bar[::3] = True
        bar[3 * x.shape[0] // 4:] = True
    got = _host_est(host_lib, x, **cfg, bar=bar, orders=True)
    want = bc7_est.estimate_topk_plain(
        torch.from_numpy(x), **cfg,
        bar=None if bar is None else torch.from_numpy(bar)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("deal", ["list", "reversed", "shuffled"])
def test_shortlist_ids_do_not_depend_on_the_deal(host_lib, deal):
    """Any order of dealing the partitions to the lanes gives the plain
    version's ids, ties included (blocks split exactly along a shape, solid
    blocks)."""
    x = _blocks()
    cfg = EST_CASES["rgb_2sub_64_k9"]
    n = len(cfg["plist"])
    order = {"list": list(range(n)), "reversed": list(range(n))[::-1],
             "shuffled": np.random.default_rng(4).permutation(n).tolist()}
    got = _host_est(host_lib, x, **cfg, deal=order[deal])
    want = bc7_est.estimate_topk_plain(torch.from_numpy(x), **cfg).numpy()
    np.testing.assert_array_equal(got, want)


def test_shortlist_launch_shape_is_the_wrappers(host_lib):
    """The header's lanes per block and threads per CTA are what
    ``bc7_est.EST_LANES`` and ``bc7_est.EST_THREADS`` report; a group lies
    inside one warp."""
    out = np.zeros(2, np.int32)
    host_lib.host_est_shape(out.ctypes.data)
    assert tuple(int(v) for v in out) == (bc7_est.EST_LANES,
                                          bc7_est.EST_THREADS)
    assert 32 % bc7_est.EST_LANES == 0 and bc7_est.EST_THREADS % 32 == 0


FAST_CASES = {
    "default": dict(),
    "fast": dict(fast=True),
    "rgb_metric": dict(perceptual=False),
    "fast_rgb_metric": dict(fast=True, perceptual=False),
    "uber1": dict(_uber=1),
    "uber2_top8": dict(_uber=2, _topk=8, perceptual=False),
}


def _host_fast(lib, x, kw, orders=False):
    """bc7_fast's search through the host build, on the shortlist the host
    build's K3 ranks for the budget; with ``orders`` every phase runs in both
    lane orders and a phase whose two orders differ fails."""
    plist, topk, uber = bc7_fast._budget(kw.get("fast", False), None,
                                         kw.get("_topk"), kw.get("_uber"))
    ids = _host_est(lib, x, 3, 2, plist, 8, topk)
    words = np.zeros((x.shape[0], 4), np.uint32)
    err = np.zeros((x.shape[0],), np.float32)
    races = lib.host_fast(x.ctypes.data, x.shape[0], ids.ctypes.data,
                          ids.shape[1], int(kw.get("perceptual", True)), uber,
                          int(orders), words.ctypes.data, err.ctypes.data)
    assert races == 0, f"{races} fast-search phases depend on their lane order"
    return words, err


def _equal_to_plain(x, kw, words, err):
    wp, ep = bc7_fast.encode_bc7_fast_blocks_plain(torch.from_numpy(x), **kw)
    same = (words == wp.numpy().view(np.uint32)).all(axis=1)
    assert same.all(), f"{(~same).sum()} of {same.size} blocks differ"
    np.testing.assert_array_equal(err, ep.numpy())


@pytest.mark.parametrize("name", list(FAST_CASES))
def test_host_built_search_equals_plain_version(host_lib, name):
    x = _blocks()
    kw = FAST_CASES[name]
    words, err = _host_fast(host_lib, x, kw)
    _equal_to_plain(x, kw, words, err)


@pytest.mark.parametrize("name", ["default", "fast", "rgb_metric", "alpha"])
def test_fast_search_phases_do_not_depend_on_lane_order(host_lib, name):
    """Every phase of the fast search leaves the same shared state with its
    lanes run in descending as in ascending order, and the words and errors
    are the plain version's; ``alpha``: the default budget on blocks that all
    carry alpha (mode 6 alone, the lanes leave after its phases)."""
    x = _blocks()
    if name == "alpha":
        x[..., 3] *= np.float32(0.98)
    kw = {} if name == "alpha" else FAST_CASES[name]
    words, err = _host_fast(host_lib, x, kw, orders=True)
    _equal_to_plain(x, kw, words, err)


def test_fast_search_launch_shape_is_the_wrappers(host_lib):
    """The header's launch shape (lanes per block, threads per CTA) is what
    ``bc7_fast.FAST_LANES`` and ``bc7_fast.FAST_THREADS`` report, a group
    lies inside one warp and has more than one lane."""
    out = np.zeros(2, np.int32)
    host_lib.host_fast_shape(out.ctypes.data)
    lanes, threads = (int(v) for v in out)
    assert (lanes, threads) == (bc7_fast.FAST_LANES, bc7_fast.FAST_THREADS)
    assert 32 % lanes == 0 and threads % 32 == 0 and lanes > 1


# -------------------------------------------------------- the full search ---

def _full_blocks():
    """32 blocks: photo, alpha gradient, solid, 0/1 alpha, two-colour splits
    along shapes of every anchor class; every third block opaque."""
    rng = np.random.default_rng(5)
    photo = _to_blocks(photo_rgba(8, 16, seed=3))                       # 8
    grad = _to_blocks(photo_rgba(8, 16, seed=4))                        # 8
    grad[..., 3] = np.linspace(0.05, 0.95, 16)[None, :]
    solid = np.repeat(rng.random((4, 1, 4), np.float32), 16, 1)         # 4
    solid[:2, :, 3] = 1.0
    zo = rng.integers(0, 2, (4, 16, 4)).astype(np.float32)              # 4
    two = []
    for shape in (0, 13, 17, 18, 34, 47, 22, 60):                       # 8
        c = rng.random((2, 4), np.float32)
        pick = [(P2[shape] >> p) & 1 for p in range(16)]
        two.append(c[pick] + rng.normal(0, 0.01, (16, 4)))
    x = np.clip(np.concatenate([photo, grad, solid, zo, np.stack(two)]),
                0, 1).astype(np.float32)
    x[::3, :, 3] = 1.0
    assert x.shape == (32, 16, 4)
    return np.ascontiguousarray(x)


def _host_search(lib, x):
    """bc7_full.bc7_mode_search's contract, run by the host build."""
    def search(blocks, mode, ids, *, iters, shake, uber, keep=1, bar=None,
               out=None):
        n = x.shape[0]
        if isinstance(ids, torch.Tensor):
            ids_np = np.ascontiguousarray(ids.numpy(), np.int32)
            idp, nids = ids_np.ctypes.data, ids_np.shape[1]
        else:
            idp, nids = None, ids or 0
        bar_np = None if bar is None else np.ascontiguousarray(
            bar.numpy(), np.uint8)
        if out is None:
            words = np.zeros((n, 4), np.uint32)
            err = np.zeros((n,), np.float32)
        else:
            words = out[0].numpy().view(np.uint32)
            err = out[1].numpy()
        lib.host_full(x.ctypes.data, n, mode, idp, nids, iters, shake, uber,
                      keep, None if bar_np is None else bar_np.ctypes.data,
                      int(out is not None), words.ctypes.data,
                      err.ctypes.data)
        if out is not None:
            return out
        return torch.from_numpy(words.view(np.int32)), torch.from_numpy(err)
    return search


FULL_BUDGETS = {"q1": dict(quality=1.0),
                "override": dict(quality=0.25, _plist=(0, 1, 5, 9, 13),
                                 _topk=2, _shake=1, _uber=1),
                "q025": dict(quality=0.25),
                "q025_top3": dict(quality=0.25, _topk=3)}


@lru_cache(maxsize=None)
def _full_plan(budget):
    kw = FULL_BUDGETS[budget]
    return bc7_full._plan(kw["quality"], 0xFF, 1.0, kw.get("_plist"),
                          kw.get("_topk"), kw.get("_shake"), kw.get("_uber"))


@pytest.mark.parametrize("mode", range(8))
@pytest.mark.parametrize("budget", list(FULL_BUDGETS))
def test_host_built_full_search_equals_plain_version(host_lib, budget, mode):
    x = _full_blocks()
    xt = torch.from_numpy(x)
    plan = _full_plan(budget)
    cfg = plan.shortlists.get(mode)
    ids = (bc7_est.estimate_topk_plain(xt, **cfg) if isinstance(cfg, dict)
           else cfg)
    bar = (bc7_full._combined_alpha_bar(xt, True, True) if mode >= 6
           else None)
    kw = dict(iters=plan.iters, shake=plan.shake, uber=plan.uber,
              keep=plan.keep, bar=bar)
    wh, eh = _host_search(host_lib, x)(xt, mode, ids, **kw)
    wp, ep = bc7_full.bc7_mode_search_plain(xt, mode, ids, **kw)
    same = (wh == wp).all(dim=1)
    assert same.all(), f"{int((~same).sum())} of {same.numel()} blocks differ"
    np.testing.assert_array_equal(eh.numpy(), ep.numpy())


@pytest.mark.parametrize("mode", range(8))
def test_full_search_phases_do_not_depend_on_lane_order(host_lib, mode):
    """Every phase of the top tier's search leaves the same shared state with
    its lanes run in descending as in ascending order, so no lane reads or
    writes another lane's data within a phase; the words and errors are the
    plain version's. Mode 6 runs on the alpha bar, mode 0 with a merge."""
    x = _full_blocks()
    xt = torch.from_numpy(x)
    plan = _full_plan("q1")
    cfg = plan.shortlists.get(mode)
    ids = (bc7_est.estimate_topk_plain(xt, **cfg) if isinstance(cfg, dict)
           else cfg)
    bar = (bc7_full._combined_alpha_bar(xt, True, True) if mode >= 6
           else None)
    kw = dict(iters=plan.iters, shake=plan.shake, uber=plan.uber,
              keep=plan.keep, bar=bar)
    if isinstance(ids, torch.Tensor):
        ids_np = np.ascontiguousarray(ids.numpy(), np.int32)
        idp, nids = ids_np.ctypes.data, ids_np.shape[1]
    else:
        idp, nids = None, ids or 0
    bar_np = None if bar is None else np.ascontiguousarray(bar.numpy(),
                                                           np.uint8)
    n = x.shape[0]
    merge = mode == 0
    run = np.random.default_rng(mode).random(n).astype(np.float32) * 4e5
    words = np.full((n, 4), 7, np.uint32)
    err = run.copy()
    races = host_lib.host_full_orders(
        x.ctypes.data, n, mode, idp, nids, plan.iters, plan.shake, plan.uber,
        plan.keep, None if bar_np is None else bar_np.ctypes.data, int(merge),
        words.ctypes.data, err.ctypes.data)
    assert races == 0, f"{races} phases depend on the order of their lanes"
    wp, ep = bc7_full.bc7_mode_search_plain(xt, mode, ids, **kw)
    wp, ep = wp.numpy().view(np.uint32), ep.numpy()
    if merge:
        take = ep < run
        wp = np.where(take[:, None], wp, np.uint32(7))
        ep = np.where(take, ep, run)
        assert 0 < take.sum() < n
    np.testing.assert_array_equal(words, wp)
    np.testing.assert_array_equal(err, ep)


@pytest.mark.parametrize("mode", range(8))
def test_full_search_launch_shape_is_the_wrappers(host_lib, mode):
    """The header's Shape<M> (lanes per block, threads per CTA) is what
    ``bc7_full.LAUNCH_SHAPES`` reports, its narrow shape Shape<M, 1> what
    ``bc7_full.NARROW_SHAPES`` reports and is launched only without
    refinement, and a group lies inside one warp."""
    out = np.zeros(6, np.int32)
    host_lib.host_shape(mode, out.ctypes.data)
    lanes, threads, nlanes, nthreads, narrow, narrow_refined = (
        int(v) for v in out)
    assert (lanes, threads) == bc7_full.LAUNCH_SHAPES[mode]
    assert (nlanes, nthreads) == bc7_full.NARROW_SHAPES[mode]
    assert 32 % lanes == 0 and threads % 32 == 0
    assert 32 % nlanes == 0 and nthreads % 32 == 0
    assert narrow == (mode not in (4, 5)) and not narrow_refined


def test_host_built_full_entry_equals_plain_version(host_lib):
    """All eight modes merged in the host build's own running best, with the
    mode 6/7 bar, against the plain entry at the top tier."""
    x = _full_blocks()
    xt = torch.from_numpy(x)
    plan = _full_plan("q1")
    bar = bc7_full._combined_alpha_bar(xt, True, True)
    wh, eh = bc7_full._encode(xt, plan, bar, bc7_est.estimate_topk_plain,
                              _host_search(host_lib, x))
    wp, ep = bc7_full.encode_bc7_blocks_plain(xt)
    assert torch.equal(wh, wp)
    np.testing.assert_array_equal(eh.numpy(), ep.numpy())


# ----------------------------------------------- the full search's scans ---

def _keep2_model(errs):
    """The one-thread search's keep-2 loop (best, runner-up)."""
    best, best2 = 0, None
    for k in range(1, len(errs)):
        take = errs[k] < errs[best]
        loser = best if take else k
        if take:
            best = k
        if best2 is None or errs[loser] < errs[best2]:
            best2 = loser
    return best, -1 if best2 is None else best2


def _uber_model(entry, errs, ok):
    """The one-thread uber loop: the entry first, skipped variants, strict <;
    -1 where the entry stays."""
    best_e, w = entry, -1
    for v, (e, o) in enumerate(zip(errs, ok)):
        if not o:
            continue
        if e < best_e:
            best_e, w = e, v
    return w


def _shake_model(errs):
    """The one-thread shake loop over steps: the start (step 0) first."""
    best_e, w = None, 0
    for j, e in enumerate(errs):
        if j == 0 or e < best_e:
            best_e, w = e, j
    return w


def _keep2(lib, errs):
    e = np.asarray(errs, np.float32)
    out = np.zeros(2, np.int32)
    lib.host_keep2(e.ctypes.data, len(e), out.ctypes.data)
    return tuple(int(v) for v in out)


def _scan_min(lib, inc, errs, ok=None):
    e = np.asarray(errs, np.float32)
    o = np.ones(len(e), np.int32) if ok is None else np.asarray(ok, np.int32)
    return lib.host_scan_min(float(inc), e.ctypes.data, o.ctypes.data, len(e))


@pytest.mark.parametrize("case", ["keep2", "uber", "shake", "random_ties"])
def test_full_search_scans_keep_the_sequential_order(host_lib, case):
    """The scans that pick a phase's winners from the slots, on crafted error
    arrays with ties, against the one-thread search's sequential loops."""
    if case == "keep2":
        # a demoted best replaces the runner-up only on a strict <
        for errs, want in (([5, 5, 3], (2, 1)), ([3, 5, 5], (0, 1)),
                           ([5, 3, 3, 4], (1, 2)), ([1, 1, 1], (0, 1)),
                           ([4, 2, 4, 2], (1, 3)), ([7], (0, -1))):
            assert _keep2_model(errs) == want
            assert _keep2(host_lib, errs) == want, errs
    elif case == "uber":
        # the entry wins a tie; a skipped variant never wins, even if smaller
        for entry, errs, ok, want in ((4, [4, 4], None, -1),
                                      (5, [5, 4, 4, 6], [1, 0, 1, 1], 2),
                                      (5, [1, 6], [0, 1], -1),
                                      (5, [6, 3, 3], None, 1)):
            ok_ = [1] * len(errs) if ok is None else ok
            assert _uber_model(entry, errs, ok_) == want
            assert _scan_min(host_lib, entry, errs, ok_) == want
    elif case == "shake":
        # the start (step 0) wins ties; among the steps the first does
        for errs, want in (([2, 2, 1, 1], 2), ([2, 2, 2], 0), ([3, 1, 2, 1], 1)):
            assert _shake_model(errs) == want
            assert 1 + _scan_min(host_lib, errs[0], errs[1:]) == want
    else:
        rng = np.random.default_rng(23)
        for _ in range(300):
            n = int(rng.integers(1, 12))
            errs = rng.integers(0, 4, n).astype(np.float32).tolist()
            ok = rng.integers(0, 2, n).tolist()
            assert _keep2(host_lib, errs) == _keep2_model(errs), errs
            assert (_scan_min(host_lib, 2.0, errs, ok)
                    == _uber_model(2.0, errs, ok)), (errs, ok)
            assert 1 + _scan_min(host_lib, errs[0], errs[1:]) == \
                _shake_model(errs), errs
