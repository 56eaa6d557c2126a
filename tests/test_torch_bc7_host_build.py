"""The BC7 CUDA searches, compiled for the host, against the plain versions.

``csrc/bc7_est.cuh`` and ``csrc/bc7_fast_search.cuh`` are plain C++ apart from
the CUDA keywords, so ``g++`` builds them against a small stub of
``cuda_runtime.h`` and a loop over blocks takes the place of the launch. That
puts the arithmetic of the kernels under test where there is no card: the same
numpy blocks go through the host build and through the plain PyTorch versions,
and the partition ids, the words and the errors must be equal on every block
(``-ffp-contract=off`` stands in for ``nvcc -fmad=false``; both sides divide,
round half to even and take correctly rounded square roots). The launch
itself, the loads and the resource use are still only checked on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu_torch.kernels import bc7_est, bc7_fast
from gfx_imagecompress_tpu_torch.tables.bc7_tables import P2

from conftest import photo_rgba

CSRC = (Path(__file__).resolve().parent.parent
        / "gfx_imagecompress_tpu_torch" / "csrc")

STUB = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__ static const
#define __launch_bounds__(x)
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct dim3s { unsigned x; };
static dim3s blockIdx, threadIdx;
inline int __popc(unsigned v) { return __builtin_popcount(v); }
using std::max;
using std::min;
enum { cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 716 };
"""

HARNESS = r"""
#include "bc7_est.cuh"
#include "bc7_fast_search.cuh"

extern "C" void host_est(const float* x, long long n, int chans, int subsets,
                         const int* plist, int nplist, int levels, int k,
                         int pca, int* ids) {
  bc7::PartList pl;
  pl.n = nplist;
  for (int j = 0; j < 64; ++j) pl.id[j] = j < nplist ? plist[j] : 0;
  for (long long i = 0; i < n; ++i) {
    if (chans == 3) {
      float xs[3][16];
      bcx::load_block<3>(x + i * 64, 4, xs);
      bc7::estimate_topk<3>(xs, subsets, pl, levels, k, pca != 0, ids + i * k);
    } else {
      float xs[4][16];
      bcx::load_block<4>(x + i * 64, 4, xs);
      bc7::estimate_topk<4>(xs, subsets, pl, levels, k, pca != 0, ids + i * k);
    }
  }
}

// the body of bc7_fast_kernel, one block after the other
extern "C" void host_fast(const float* x, long long n, const int* ids,
                          int nids, int perceptual, int uber,
                          unsigned* words, float* err) {
  for (long long i = 0; i < n; ++i) {
    const float4* p4 = reinterpret_cast<const float4*>(x + i * 64);
    float xs[4][16];
    float raw[3];
    for (int p = 0; p < 16; ++p) {
      const float4 v = p4[p];
      xs[0][p] = v.x * 255.0f;
      xs[1][p] = v.y * 255.0f;
      xs[2][p] = v.z * 255.0f;
      xs[3][p] = v.w * 255.0f;
      raw[0] = p ? raw[0] + v.x : v.x;
      raw[1] = p ? raw[1] + v.y : v.y;
      raw[2] = p ? raw[2] + v.z : v.z;
    }
    bc7::Bits128 out;
    float e;
    bc7::fast_search(xs, raw, ids + i * nids, nids, perceptual != 0, uber,
                     out, e);
    words[4 * i] = (unsigned)out.lo;
    words[4 * i + 1] = (unsigned)(out.lo >> 32);
    words[4 * i + 2] = (unsigned)out.hi;
    words[4 * i + 3] = (unsigned)(out.hi >> 32);
    err[i] = e;
  }
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
    lib.host_est.argtypes = [p, ll, i, i, p, i, i, i, i, p]
    lib.host_fast.argtypes = [p, ll, p, i, i, i, p, p]
    lib.host_est.restype = lib.host_fast.restype = None
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


def _host_est(lib, x, chans, subsets, plist, levels, k, estimator="bounds"):
    pl = np.asarray(plist, np.int32)
    k = min(k, len(pl))
    ids = np.zeros((x.shape[0], k), np.int32)
    lib.host_est(x.ctypes.data, x.shape[0], chans, subsets, pl.ctypes.data,
                 len(pl), levels, k, int(estimator == "pca"),
                 ids.ctypes.data)
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
}


@pytest.mark.parametrize("name", list(EST_CASES))
def test_host_built_shortlist_equals_plain_version(host_lib, name):
    x = _blocks()
    cfg = EST_CASES[name]
    got = _host_est(host_lib, x, **cfg)
    want = bc7_est.estimate_topk_plain(torch.from_numpy(x), **cfg).numpy()
    np.testing.assert_array_equal(got, want)


FAST_CASES = {
    "default": dict(),
    "fast": dict(fast=True),
    "rgb_metric": dict(perceptual=False),
    "fast_rgb_metric": dict(fast=True, perceptual=False),
    "uber1": dict(_uber=1),
    "uber2_top8": dict(_uber=2, _topk=8, perceptual=False),
}


@pytest.mark.parametrize("name", list(FAST_CASES))
def test_host_built_search_equals_plain_version(host_lib, name):
    x = _blocks()
    kw = FAST_CASES[name]
    plist, topk, uber = bc7_fast._budget(kw.get("fast", False), None,
                                         kw.get("_topk"), kw.get("_uber"))
    perceptual = kw.get("perceptual", True)
    ids = _host_est(host_lib, x, 3, 2, plist, 8, topk)
    words = np.zeros((x.shape[0], 4), np.uint32)
    err = np.zeros((x.shape[0],), np.float32)
    host_lib.host_fast(x.ctypes.data, x.shape[0], ids.ctypes.data,
                       ids.shape[1], int(perceptual), uber,
                       words.ctypes.data, err.ctypes.data)
    wp, ep = bc7_fast.encode_bc7_fast_blocks_plain(torch.from_numpy(x), **kw)
    same = (words == wp.numpy().view(np.uint32)).all(axis=1)
    assert same.all(), f"{(~same).sum()} of {same.size} blocks differ"
    np.testing.assert_array_equal(err, ep.numpy())
