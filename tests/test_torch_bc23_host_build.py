"""The BC3 kernel's phases (K1b) and the BC2 kernel's one-thread block (K1c),
compiled for the host, against the plain versions.

``csrc/bc23_group.cuh`` is plain C++ apart from the CUDA keywords (the kernels
and launchers sit behind ``__CUDACC__``), so ``g++`` builds it against the
small stub of ``cuda_runtime.h`` that ``tests/test_torch_bc7_host_build.py``
uses, and a loop over blocks takes the place of the launch. Each K1b phase
runs as a loop over its lanes: the colour group's (``bc1_group_load`` with
the alpha, ``bc3_colour``), each alpha family's (``bc3_family``, one thread
per block and family) and the split finish's (``bc3_alpha_half``, one
thread per family), in the order the CTA runs its stages between barriers;
the pick, pack and write are the card's ``bc3_finish``. K1c's ``bc2_block``
runs as the card's thread runs it. The same numpy blocks go through the host
build and through ``encode_bc3_blocks_plain`` / ``encode_bc2_blocks_plain``,
and the words and errors must be equal on
every block (``-ffp-contract=off`` stands in for ``nvcc -fmad=false``). With
``orders``, the state is filled with 0xFF bytes before each block (a read of
what no phase wrote reads NaN), every phase runs with its lanes in
descending and then ascending order, and the stage in which the colour
groups and the two families run side by side runs with its roles in reverse
order and then in order; both must leave equal states. The launch, the loads
and the resource use are checked only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu_torch.kernels import bc1

from test_torch_bc1_host_build import _blocks
from test_torch_bc7_host_build import CSRC, STUB

HARNESS = r"""
#include "bc23_group.cuh"

#include <cstring>

// The shared structs of one block and the registers of its colour lanes.
struct HostState {
  bcx::Bc1Block b;
  bcx::Bc1Fit f;
  bcx::Bc3Alpha al;
  bcx::Bc1Lane r[bcx::BC1_LANES];
};
static HostState g_st;
static int g_orders = 0;
static long long g_races = 0;

// state changes that depend on the order of f(true) and f(false) count as
// races; f(false) is the order kept
template <class F>
static void both_orders(F&& f) {
  if (!g_orders) {
    f(false);
    return;
  }
  static HostState before, other;
  std::memcpy(&before, &g_st, sizeof(HostState));
  f(true);
  std::memcpy(&other, &g_st, sizeof(HostState));
  std::memcpy(&g_st, &before, sizeof(HostState));
  f(false);
  if (std::memcmp(&other, &g_st, sizeof(HostState))) ++g_races;
}

// a phase of L lanes; call(f, lane) runs lane `lane` of it
template <int L, class F, class Call>
static void run_lanes(F&& f, Call&& call) {
  both_orders([&](bool down) {
    for (int k = 0; k < L; ++k) call(f, down ? L - 1 - k : k);
  });
}

struct RunColour {
  template <class F>
  void operator()(F&& ph) const {
    run_lanes<bcx::BC1_LANES>(ph, [](auto& p, int l) { p(l, g_st.r[l]); });
  }
};
// the stage between K1b's barriers: the colour groups and the two families
static void bc3_search(const bcx::Bc1Budget& bud, int ai, int ar, int ao, bool reverse) {
  auto colour = [&] { bcx::bc3_colour(g_st.b, g_st.f, bud, RunColour()); };
  auto fam8 = [&] { bcx::bc3_family<true>(g_st.al, ai, ar, ao); };
  auto fam6 = [&] { bcx::bc3_family<false>(g_st.al, ai, ar, ao); };
  if (reverse) { fam6(); fam8(); colour(); }
  else { colour(); fam8(); fam6(); }
}

static void bc3_block(const float* x, long long i, const bcx::Bc1Budget& bud, int ai, int ar,
                      int ao, unsigned* words, float* err) {
  bcx::bc1_group_load<false>(g_st.b, x + i * 64, 4, bud, RunColour(), g_st.al.a);
  both_orders([&](bool rev) { bc3_search(bud, ai, ar, ao, rev); });
  run_lanes<2>([](int h) { bcx::bc3_alpha_half(g_st.al, h); },
               [](auto& p, int h) { p(h); });
  uint4 w;
  bcx::bc3_finish(g_st.b, g_st.f, g_st.al, w, err[i]);
  words[4 * i] = w.x; words[4 * i + 1] = w.y;
  words[4 * i + 2] = w.z; words[4 * i + 3] = w.w;
}

// K1c: one thread per block
static void bc2_block(const float* x, long long i, const bcx::Bc1Budget& bud,
                      unsigned* words, float* err) {
  float rgba[4][16];
  bcx::load_block<4>(x + i * 64, 4, rgba);
  uint4 w;
  bcx::bc2_block(rgba, bud, w, err[i]);
  words[4 * i] = w.x; words[4 * i + 1] = w.y;
  words[4 * i + 2] = w.z; words[4 * i + 3] = w.w;
}

// bc3_encode's contract (which = 3) or bc2_encode's (which = 2) on (n,16,4)
// blocks; with `orders`, each
// K1b phase in both lane orders and the search stage in both role orders.
// Returns the number of phases and stages whose orders left different
// states.
extern "C" long long host_bc23(int which, const float* x, long long n,
                               const float* w, int iters, int passes, int adaptive,
                               int ai, int ar, int ao, int orders, unsigned* words,
                               float* err) {
  const bcx::Bc1Budget bud = bcx::bc23_budget(w[0], w[1], w[2], iters, passes, adaptive);
  g_orders = orders;
  g_races = 0;
  for (long long i = 0; i < n; ++i) {
    std::memset(&g_st, 0xFF, sizeof(HostState));
    if (which == 2) bc2_block(x, i, bud, words, err);
    else bc3_block(x, i, bud, ai, ar, ao, words, err);
  }
  g_orders = 0;
  return g_races;
}

// K1b's launch shape: threads per CTA, of them the colour groups'
extern "C" void host_bc23_shape(int* out) {
  out[0] = bcx::BC3_THREADS;
  out[1] = bcx::BC3_COLOUR;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA search headers for the host")
    d = tmp_path_factory.mktemp("bc23_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libbc23_host.so"
    r = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math",
         "-Wno-unknown-pragmas", "-shared", "-fPIC", "-I", str(d), "-I",
         str(CSRC), "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_bc23.argtypes = [i, p, ll, p, i, i, i, i, i, i, i, p, p]
    lib.host_bc23.restype = ll
    lib.host_bc23_shape.argtypes = [p]
    lib.host_bc23_shape.restype = None
    return lib


# chip_smoke.py's BC3 and BC2 budgets, and BC3 at a radius that leaves the
# first round nothing to try
BC3_BUDGETS = {"default": {}, "passes2": {"passes": 2},
               "adaptive": {"adaptive": True},
               "alpha_r1": {"a_radius": 1, "a_rounds": 1},
               "alpha_r0_4rounds": {"a_radius": 0, "a_rounds": 4}}
BC2_BUDGETS = {"default": {}, "passes2": {"passes": 2},
               "adaptive": {"adaptive": True}}


def _host(lib, which, x, kw, orders=False):
    """bc3_encode's (``which`` 3) or bc2_encode's (2) contract through the
    host build; returns (words (N,4) uint32, err (N,), phases and stages
    whose orders differ)."""
    k = dict(iters=3, passes=1, adaptive=False, a_iters=3, a_radius=2,
             a_rounds=2)
    k.update(kw)
    n = x.shape[0]
    w = np.asarray(bc1.PERCEPTUAL_WEIGHTS, np.float32)
    words = np.zeros((n, 4), np.uint32)
    err = np.zeros((n,), np.float32)
    races = lib.host_bc23(
        which, x.ctypes.data, n, w.ctypes.data, k["iters"], k["passes"], int(k["adaptive"]),
        k["a_iters"], k["a_radius"], k["a_rounds"], int(orders),
        words.ctypes.data, err.ctypes.data)
    return words, err, races


def _plain(which, x, kw):
    enc = (bc1.encode_bc3_blocks_plain if which == 3
           else bc1.encode_bc2_blocks_plain)
    wp, ep = enc(torch.from_numpy(x), **kw)
    return wp.numpy().view(np.uint32), ep.numpy()


def _assert_equal(got, want):
    (wh, eh), (wp, ep) = got, want
    same = (wh == wp).all(axis=1)
    assert same.all(), f"{(~same).sum()} of {same.size} blocks differ"
    np.testing.assert_array_equal(eh, ep)


@pytest.mark.parametrize("budget", list(BC3_BUDGETS))
def test_host_built_bc3_equals_plain_version(host_lib, budget):
    x = _blocks()
    wh, eh, _ = _host(host_lib, 3, x, BC3_BUDGETS[budget])
    _assert_equal((wh, eh), _plain(3, x, BC3_BUDGETS[budget]))


@pytest.mark.parametrize("budget", list(BC2_BUDGETS))
def test_host_built_bc2_equals_plain_version(host_lib, budget):
    x = _blocks()
    wh, eh, _ = _host(host_lib, 2, x, BC2_BUDGETS[budget])
    _assert_equal((wh, eh), _plain(2, x, BC2_BUDGETS[budget]))


# the lane-order check's budgets: chip_smoke.py's, and a radius of 3 for
# rounds of 48 candidates
ORDER_BUDGETS = {"default": {}, "adaptive": {"adaptive": True},
                 "alpha_r1": {"a_radius": 1, "a_rounds": 1},
                 "alpha_r3": {"a_radius": 3, "a_rounds": 3}}


@pytest.mark.parametrize("budget", list(ORDER_BUDGETS))
def test_bc3_phases_do_not_depend_on_lane_order(host_lib, budget):
    """Each phase of K1b leaves the same state with its lanes in descending
    as in ascending order, the search stage the same with the colour groups
    and the two families in either order (no role reads what another
    writes before the barrier), from a state of 0xFF bytes. The words and
    errors are the plain version's."""
    x = _blocks()[::2].copy()
    kw = ORDER_BUDGETS[budget]
    wh, eh, races = _host(host_lib, 3, x, kw, orders=True)
    assert races == 0, f"{races} phases depend on the order of their lanes"
    _assert_equal((wh, eh), _plain(3, x, kw))


def test_bc3_launch_shape_is_the_wrappers(host_lib):
    """The header's launch shape of K1b is what ``kernels/bc1.py`` reports:
    the colour groups' lanes and one thread per block and alpha family, each
    role whole warps."""
    out = np.zeros(2, np.int32)
    host_lib.host_bc23_shape(out.ctypes.data)
    threads, colour = (int(v) for v in out)
    assert threads == bc1.BC3_THREADS
    assert colour == bc1.BC1_CTA_BLOCKS * bc1.BC1_LANES
    assert threads == colour + 2 * bc1.BC1_CTA_BLOCKS
    assert colour % 32 == 0 and bc1.BC1_CTA_BLOCKS % 32 == 0
