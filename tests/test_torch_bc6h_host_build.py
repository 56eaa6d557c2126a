"""The BC6H CUDA search, compiled for the host, against the plain version.

``csrc/bc6h_search.cuh`` is plain C++ apart from the CUDA keywords (its
kernel and launcher sit behind ``__CUDACC__``), so ``g++`` builds it against
a small stub of ``cuda_runtime.h`` and a loop over blocks takes the place of
the launch. The search is written as phases of a group of lanes over a shared
struct; here each phase runs as a loop over the lanes (the card's own phase
and scan code), and in the lane-order test once more in descending order,
which must leave the same state. The same half-ints go through the host
build and through
``kernels/bc6h.py``'s plain version, and the words and the errors must be
equal on every block (``-ffp-contract=off`` stands in for ``nvcc
-fmad=false``; both sides divide, round half to even and take correctly
rounded square roots). 32 mixed HDR blocks at every quality tier, unsigned
and signed, and under four mode masks: one region only, transformed
two-region modes only (the solid-mean fallback), mode 10 only, mode 14 only.
This is the only check of the kernel's arithmetic at the top tier that runs
where there is no card; the launch, the loads and the resource use are
checked on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu_torch.kernels import bc6h

from test_torch_bc7_host_build import STUB

CSRC = (Path(__file__).resolve().parent.parent
        / "gfx_imagecompress_tpu_torch" / "csrc")

HARNESS = r"""
#include "bc6h_search.cuh"

#include <cstring>

// With g_orders set, every phase runs twice from the same shared state: its
// lanes in descending order, then ascending. A phase in which one lane reads
// or writes what another lane writes in the same phase (a race between the
// card's lanes, which only the group's barrier orders) leaves two different
// states; g_races counts those phases.
static int g_orders = 0;
static long long g_races = 0;

// block i of the kernel in the shape of L lanes: each phase as a loop over
// the lanes; the group's struct is filled with 0xFF bytes first, so a phase
// that reads what no earlier phase of this block wrote reads NaNs
template <bool SG, int L>
static void host_shaped(const int* h, long long i, int topk, int iters,
                        int shake, int mode_mask, int fb, unsigned* words,
                        float* err) {
  using Sh = bc6h::Shared<L>;
  static Sh sh, before, down;
  std::memset(&sh, 0xFF, sizeof(Sh));
  bc6h::search_block<SG, L>(sh, h, i, topk, iters, shake, mode_mask, fb,
                            words, err, [](auto&& f) {
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

// bc6h_encode's contract; with `orders`, every phase in both lane orders. Returns the number of phases
// whose two orders left different shared states.
extern "C" long long host_bc6h(const int* h, long long n, int sg, int topk,
                               int iters, int shake, int mode_mask, int fb,
                               int orders, unsigned* words, float* err) {
  g_orders = orders;
  g_races = 0;
  for (long long i = 0; i < n; ++i) {
    if (sg)
      host_shaped<true, bc6h::LANES>(h, i, topk, iters, shake, mode_mask, fb,
                                     words, err);
    else
      host_shaped<false, bc6h::LANES>(h, i, topk, iters, shake, mode_mask,
                                      fb, words, err);
  }
  g_orders = 0;
  return g_races;
}

// the launch shape: lanes per block and threads per CTA
extern "C" void host_bc6h_shape(int* out) {
  out[0] = bc6h::LANES;
  out[1] = bc6h::Shape<bc6h::LANES>::THREADS;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA search header for the host")
    d = tmp_path_factory.mktemp("bc6h_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libbc6h_host.so"
    r = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math",
         "-Wno-unknown-pragmas", "-shared", "-fPIC", "-I", str(d), "-I",
         str(CSRC), "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_bc6h.argtypes = [p, ll, i, i, i, i, i, i, i, p, p]
    lib.host_bc6h.restype = ll
    lib.host_bc6h_shape.argtypes = [p]
    lib.host_bc6h_shape.restype = None
    return lib


def mixed_hdr_blocks(n=32, seed=11, signed=False):
    """(n,16,3) float32 HDR blocks, n a multiple of 8: smooth environment-map
    blocks with multiplicative noise, a solid block and a zero block, values
    at and above the half range (65504, 70000, +inf), negatives, values in
    the half subnormal range, and strong two-level contrast; with ``signed``
    every other smooth block has its green channel negated."""
    r = np.random.default_rng(seed)
    k = n // 8
    y, x = np.mgrid[0:4 * k, 0:8].astype(np.float32)
    env = np.stack([np.exp(np.sin(x * 0.3 + y * 0.2) * 2.0),
                    np.exp(np.cos(y * 0.25) * 1.5) * 0.3,
                    (np.sin((x + y) * 0.2) * 0.5 + 0.6) * 10.0], -1)
    env *= 1.0 + r.normal(0, 0.01, env.shape)
    env = env.reshape(k, 4, 2, 4, 3).transpose(0, 2, 1, 3, 4)
    env = env.reshape(2 * k, 16, 3)
    if signed:
        env[::2, :, 1] *= -1.0
    solid = np.repeat(r.random((k, 1, 3)) * 50.0, 16, 1)
    solid[0] = 0.0
    big = r.choice([65504.0, 70000.0, np.inf, 1000.0, 60000.0],
                   (k, 16, 3))
    neg = r.normal(0, 5.0, (k, 16, 3))
    sub = r.random((k, 16, 3)) * 6e-5
    contrast = np.where(r.random((k, 16, 3)) < 0.5, 60000.0, 1e-4)
    wide = np.exp(r.uniform(-12, 11, (k, 16, 3))) * np.where(
        r.random((k, 16, 3)) < (0.3 if signed else 0.0), -1.0, 1.0)
    out = np.concatenate([env, solid, big, neg, sub, contrast, wide], 0)
    assert out.shape == (n, 16, 3)
    return out.astype(np.float32)


TIERS = {"q03": 0.3, "q07": 0.7, "q08": 0.8, "q1": 1.0}
MASKS = {"one_region": 0x3C00, "transformed_two_region": 0x1FF,
         "mode10": 0x200, "mode14": 0x2000}
CASES = ([(f"{t}", TIERS[t], 0xFFFF) for t in TIERS]
         + [(f"q1_{m}", 1.0, MASKS[m]) for m in MASKS])


def _host_search(lib, h, signed, topk, iters, shake, mask, orders=False):
    """bc6h_encode's contract through the host build; with ``orders`` every
    phase runs in both lane orders and a phase whose two orders differ
    fails."""
    hn = np.ascontiguousarray(h.numpy())
    n = hn.shape[0]
    words = np.zeros((n, 4), np.uint32)
    err = np.zeros((n,), np.float32)
    fb = bc6h.fallback_mode(mask)
    races = lib.host_bc6h(hn.ctypes.data, n, int(signed), topk, iters, shake,
                          mask, -1 if fb is None else fb, int(orders),
                          words.ctypes.data, err.ctypes.data)
    assert races == 0, f"{races} BC6H phases depend on their lane order"
    return words, err


def _equal_to_plain(h, signed, topk, iters, shake, mask, words, err):
    wp, ep = bc6h.bc6h_search_plain(h, signed=signed, topk=topk, iters=iters,
                                    shake=shake, mode_mask=mask)
    same = (words == wp.numpy().view(np.uint32)).all(axis=1)
    assert same.all(), f"{(~same).sum()} of {same.size} blocks differ"
    np.testing.assert_array_equal(err, ep.numpy())


@pytest.mark.parametrize("signed", [False, True],
                         ids=["unsigned", "signed"])
@pytest.mark.parametrize("name,quality,mask", CASES,
                         ids=[c[0] for c in CASES])
def test_host_built_search_equals_plain_version(host_lib, name, quality,
                                                mask, signed):
    x = torch.from_numpy(mixed_hdr_blocks(signed=signed))
    h = bc6h.f32_to_half_int(x, signed).contiguous()
    topk, iters, shake = bc6h._budgets(quality)
    words, err = _host_search(host_lib, h, signed, topk, iters, shake, mask)
    _equal_to_plain(h, signed, topk, iters, shake, mask, words, err)


ORDER_CASES = [("q1", 1.0, 0xFFFF), ("q03", 0.3, 0xFFFF),
               ("q1_transformed_two_region", 1.0, 0x1FF)]


@pytest.mark.parametrize("signed", [False, True],
                         ids=["unsigned", "signed"])
@pytest.mark.parametrize("name,quality,mask", ORDER_CASES,
                         ids=[c[0] for c in ORDER_CASES])
def test_search_phases_do_not_depend_on_lane_order(host_lib, name, quality,
                                                   mask, signed):
    """Every phase leaves the same shared state with its lanes run in
    descending as in ascending order, so no lane reads or writes another
    lane's data within a phase; the words and errors are the plain
    version's. At the top tier (the shake), at quality 0.3, and under a mask
    of transformed two-region modes only (the solid-mean fallback)."""
    x = torch.from_numpy(mixed_hdr_blocks(signed=signed))
    h = bc6h.f32_to_half_int(x, signed).contiguous()
    topk, iters, shake = bc6h._budgets(quality)
    words, err = _host_search(host_lib, h, signed, topk, iters, shake, mask,
                              orders=True)
    _equal_to_plain(h, signed, topk, iters, shake, mask, words, err)


def test_launch_shape_is_the_wrappers(host_lib):
    """The header's launch shape (lanes per block, threads per CTA) is what
    ``bc6h.BC6H_LANES`` and ``bc6h.BC6H_THREADS`` report, a group lies
    inside one warp and has more than one lane."""
    out = np.zeros(2, np.int32)
    host_lib.host_bc6h_shape(out.ctypes.data)
    lanes, threads = (int(v) for v in out)
    assert (lanes, threads) == (bc6h.BC6H_LANES, bc6h.BC6H_THREADS)
    assert 32 % lanes == 0 and threads % 32 == 0 and lanes > 1
