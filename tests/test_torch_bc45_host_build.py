"""The BC4 and BC5 kernels' phases (K2a, K2b), compiled for the host, against
the plain versions.

``csrc/bc45_group.cuh`` is plain C++ apart from the CUDA keywords (the kernels
and launchers sit behind ``__CUDACC__``), so ``g++`` builds it against the
small stub of ``cuda_runtime.h`` that ``tests/test_torch_bc7_host_build.py``
uses, and a loop over blocks takes the place of the launch. Each phase of a
block runs as a loop over the block's lanes (2 * L per channel: L for the
8-point family, L for the 6-point one), with the card's own phase, deal and
scan code; lane 0's finish packs the words. The same numpy blocks go through
the host build and through ``encode_bc4_blocks_plain`` /
``encode_bc5_blocks_plain``, and the words and errors must be equal on every
block (``-ffp-contract=off`` stands in for ``nvcc -fmad=false``). With
``orders``, the state (the channels' shared structs and every lane's
registers) is filled with 0xFF bytes before each block (a read of what no
phase wrote reads NaN), and every phase runs with its lanes in descending
and then ascending order; both must leave equal states. The launch, the
loads and the resource use are checked only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu_torch.kernels import bc4

from test_torch_bc1_host_build import _blocks
from test_torch_bc7_host_build import CSRC, STUB

# the lane counts the host build instantiates: the sweep's
LANES = (1, 2, 4, 8)

HARNESS = r"""
#include "bc45_group.cuh"

#include <cstring>

static int g_orders = 0;
static long long g_races = 0;

// The shared structs of a block's channels and the registers of its lanes.
template <int L, int NCH>
struct HostState {
  bcx::Bc45Chan<L> sh[NCH];
  bcx::Bc45Lane r[2 * L * NCH];
};

// One block: every phase a loop over the block's lanes (with `orders`, in
// descending and then ascending order, counting the phases whose orders
// left different states), then lane 0's finish.
template <int L, int NCH>
static void block(const float* px, int C, int iters, int radius, int rounds, unsigned* w,
                  float* e) {
  constexpr int BL = 2 * L * NCH;
  static HostState<L, NCH> st, before, other;
  std::memset(&st, 0xFF, sizeof st);
  auto run = [&](auto&& f) {
    if (!g_orders) {
      for (int l = 0; l < BL; ++l) f(l, st.r[l]);
      return;
    }
    std::memcpy(&before, &st, sizeof st);
    for (int l = BL - 1; l >= 0; --l) f(l, st.r[l]);
    std::memcpy(&other, &st, sizeof st);
    std::memcpy(&st, &before, sizeof st);
    for (int l = 0; l < BL; ++l) f(l, st.r[l]);
    if (std::memcmp(&other, &st, sizeof st)) ++g_races;
  };
  bcx::bc45_search<L, NCH>(st.sh, px, C, iters, radius, rounds, run);
  uint32_t ww[2 * NCH];
  bcx::bc45_finish<L, NCH>(st.sh, ww, *e);
  for (int q = 0; q < 2 * NCH; ++q) w[q] = ww[q];
}

template <int L>
static void blocks(int nch, const float* x, long long n, int C, int iters, int radius,
                   int rounds, unsigned* words, float* err) {
  for (long long i = 0; i < n; ++i) {
    if (nch == 1) block<L, 1>(x + 16 * i, 1, iters, radius, rounds, words + 2 * i, err + i);
    else block<L, 2>(x + 16 * C * i, C, iters, radius, rounds, words + 4 * i, err + i);
  }
}

// bc4_encode's contract (nch 1: x (n,16)) or bc5_encode's (nch 2: x
// (n,16,C)) at L lanes per block and family; returns the number of phases
// whose lane orders left different states (with `orders`), or -1 for an L
// the build does not have.
extern "C" long long host_bc45(int L, int nch, const float* x, long long n, int C, int iters,
                               int radius, int rounds, int orders, unsigned* words,
                               float* err) {
  g_orders = orders;
  g_races = 0;
  switch (L) {
    case 1: blocks<1>(nch, x, n, C, iters, radius, rounds, words, err); break;
    case 2: blocks<2>(nch, x, n, C, iters, radius, rounds, words, err); break;
    case 4: blocks<4>(nch, x, n, C, iters, radius, rounds, words, err); break;
    case 8: blocks<8>(nch, x, n, C, iters, radius, rounds, words, err); break;
    default: return -1;
  }
  g_orders = 0;
  return g_races;
}

// The launch shape: lanes per block, channel and family, threads per CTA,
// and the blocks per CTA of K2a and K2b
extern "C" void host_bc45_shape(int* out) {
  out[0] = bcx::BC45_LANES;
  out[1] = bcx::BC45_THREADS;
  out[2] = bcx::Bc45Shape<bcx::BC45_LANES, 1, bcx::BC45_THREADS>::BLOCKS;
  out[3] = bcx::Bc45Shape<bcx::BC45_LANES, 2, bcx::BC45_THREADS>::BLOCKS;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA search headers for the host")
    d = tmp_path_factory.mktemp("bc45_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libbc45_host.so"
    r = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math",
         "-Wno-unknown-pragmas", "-shared", "-fPIC", "-I", str(d), "-I",
         str(CSRC), "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_bc45.argtypes = [i, i, p, ll, i, i, i, i, i, p, p]
    lib.host_bc45.restype = ll
    lib.host_bc45_shape.argtypes = [p]
    lib.host_bc45_shape.restype = None
    return lib


# chip_smoke.py's budgets (default, r1, r3), a first round with nothing to
# try, and no least-squares round
BUDGETS = {"default": {}, "r1": {"radius": 1, "rounds": 1},
           "r3": {"radius": 3, "rounds": 3},
           "r0_4rounds": {"radius": 0, "rounds": 4},
           "no_fit": {"iters": 0}}


def _tie_blocks(n, seed):
    """(n,16) blocks whose seeds or climb rounds meet ties that decide the
    winner (on these, a scan that let a later candidate win a tie gives other
    words): a third of three exact levels k/255 a step of 1-8 apart, a third
    of low noise around a level, a third of three exact levels near 0, near
    255 and anywhere (ties between the 6-point family's seeds)."""
    rng = np.random.default_rng(seed)
    h = n // 3
    a = rng.integers(0, 240, (h, 1))
    step = rng.integers(1, 9, (h, 1))
    three = (a + rng.integers(0, 3, (h, 16)) * step) / 255.0
    noisy = np.clip(rng.random((h, 1)) + rng.normal(0, 0.02, (h, 16)), 0, 1)
    m = n - 2 * h
    lv = np.concatenate([rng.integers(0, 6, (m, 1)),
                         rng.integers(250, 256, (m, 1)),
                         rng.integers(0, 256, (m, 1))], 1)
    edge = np.take_along_axis(lv, rng.integers(0, 3, (m, 16)), 1) / 255.0
    return np.concatenate([three, noisy, edge]).astype(np.float32)


def _inputs():
    """BC4: the alpha channel of the BC1 harness's 320 blocks (alpha at and
    near the 128/255 threshold, all-transparent, solid, two-level), their
    red channel and 384 blocks with deciding ties, (1024,16); BC5: their
    (R,G) and (B,A) pairs and 384 pairs of tie blocks, (1024,16,2)."""
    x = _blocks()
    bc4_x = np.concatenate([x[..., 3], x[..., 0], _tie_blocks(384, 21)])
    bc5_x = np.concatenate([x[..., :2], x[..., 2:],
                            np.stack([_tie_blocks(384, 22),
                                      _tie_blocks(384, 23)], -1)])
    return np.ascontiguousarray(bc4_x), np.ascontiguousarray(bc5_x)


def _host(lib, lanes, x, kw, orders=False):
    """K2a's (x (N,16)) or K2b's (x (N,16,C)) contract through the host build
    at ``lanes`` lanes per block and family; returns (words, err, phases
    whose lane orders differ)."""
    k = dict(iters=3, radius=2, rounds=2)
    k.update(kw)
    nch = 1 if x.ndim == 2 else 2
    n = x.shape[0]
    words = np.zeros((n, 2 * nch), np.uint32)
    err = np.zeros((n,), np.float32)
    races = lib.host_bc45(lanes, nch, x.ctypes.data, n,
                          1 if nch == 1 else x.shape[2], k["iters"],
                          k["radius"], k["rounds"], int(orders),
                          words.ctypes.data, err.ctypes.data)
    assert races >= 0
    return words, err, races


def _plain(x, kw):
    enc = (bc4.encode_bc4_blocks_plain if x.ndim == 2
           else bc4.encode_bc5_blocks_plain)
    wp, ep = enc(torch.from_numpy(x), **kw)
    return wp.numpy().view(np.uint32), ep.numpy()


def _assert_equal(got, want):
    (wh, eh), (wp, ep) = got, want
    same = (wh == wp).all(axis=1)
    assert same.all(), f"{(~same).sum()} of {same.size} blocks differ"
    np.testing.assert_array_equal(eh, ep)


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("kernel", ["bc4", "bc5"])
def test_host_built_bc45_equals_plain_version(host_lib, kernel, budget):
    """The shipped launch shape of K2a / K2b on every block at each budget."""
    bc4_x, bc5_x = _inputs()
    x = bc4_x if kernel == "bc4" else bc5_x
    kw = BUDGETS[budget]
    wh, eh, _ = _host(host_lib, bc4.BC45_LANES, x, kw)
    _assert_equal((wh, eh), _plain(x, kw))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("kernel", ["bc4", "bc5"])
def test_host_built_bc45_at_every_swept_lane_count(host_lib, kernel, lanes):
    """The sweep's launch shapes give the plain version's words too, at the
    default budget and at radius 3 (three candidates or more per lane in
    round 0 at every lane count)."""
    bc4_x, bc5_x = _inputs()
    x = (bc4_x if kernel == "bc4" else bc5_x)[::2].copy()
    for kw in ({}, BUDGETS["r3"]):
        wh, eh, _ = _host(host_lib, lanes, x, kw)
        _assert_equal((wh, eh), _plain(x, kw))


def test_host_built_bc5_reads_the_first_two_of_four_channels(host_lib):
    """K2b on (N,16,4) blocks reads channels 0 and 1, as the wrapper passes
    an RGBA tensor."""
    x = _blocks()[::2].copy()
    wh, eh, _ = _host(host_lib, bc4.BC45_LANES, x, {})
    _assert_equal((wh, eh), _plain(x, {}))


@pytest.mark.parametrize("kw", [{}, {"radius": 1, "rounds": 1},
                                {"iters": 0, "radius": 0}],
                         ids=["default", "r1", "no_fit_no_climb"])
def test_host_built_bc4_search_equals_plain_version(host_lib, kw):
    """The scalar search of one channel, run through K2a's group: the two
    families, the pick, the winner's indices (the alpha channel of the BC1
    harness's blocks)."""
    x = np.ascontiguousarray(_blocks()[..., 3])
    wh, eh, _ = _host(host_lib, bc4.BC45_LANES, x, kw)
    wp, ep = bc4.encode_bc4_blocks_plain(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(wh, wp.numpy().view(np.uint32))
    np.testing.assert_array_equal(eh, ep.numpy())


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("kernel", ["bc4", "bc5"])
def test_bc45_phases_do_not_depend_on_lane_order(host_lib, kernel, budget,
                                                 lanes):
    """Each phase of K2a / K2b, at the shipped launch shape and at the
    sweep's, leaves the same state with its lanes in descending as in
    ascending order, from a state of 0xFF bytes: no lane reads what another
    lane of its warp writes in the same phase. The words and errors are the
    plain version's."""
    bc4_x, bc5_x = _inputs()
    x = (bc4_x if kernel == "bc4" else bc5_x)[::2].copy()
    kw = BUDGETS[budget]
    wh, eh, races = _host(host_lib, lanes, x, kw, orders=True)
    assert races == 0, f"{races} phases depend on the order of their lanes"
    _assert_equal((wh, eh), _plain(x, kw))


def test_bc45_launch_shape_is_the_wrappers(host_lib):
    """The header's launch shape of K2a and K2b is what ``kernels/bc4.py``
    reports: lanes per block, channel and family, threads per CTA, and whole
    blocks per CTA inside whole warps."""
    out = np.zeros(4, np.int32)
    host_lib.host_bc45_shape(out.ctypes.data)
    lanes, threads, b4, b5 = (int(v) for v in out)
    assert (lanes, threads) == (bc4.BC45_LANES, bc4.BC45_THREADS)
    assert lanes in LANES
    assert b4 == threads // (2 * lanes) and b5 == threads // (4 * lanes)
    assert threads % 32 == 0 and 32 % (4 * lanes) == 0
