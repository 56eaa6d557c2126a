"""The BC1 CUDA search, compiled for the host, against the plain version.

``csrc/bc1_search.cuh`` is plain C++ apart from the CUDA keywords, so ``g++``
builds it against the small stub of ``cuda_runtime.h`` that
``tests/test_torch_bc7_host_build.py`` uses, and a loop over blocks takes the
place of the launch. K1a's search is written as phases of a group of lanes
over shared structs (``bc1_group_load``, ``bc1_group_fit``,
``bc1_group_race``); here each phase runs as a loop over the lanes, the two
colour modes of a block one after the other, so the host build runs the
card's own phase and scan code. The same numpy blocks go through the host
build and through ``encode_bc1_blocks_plain``, and the words and errors must
be equal on every block (``-ffp-contract=off`` stands in for ``nvcc
-fmad=false``). The one-thread ``bc1_search`` that K1c calls is held to
the plain version's 4-colour search the same way; K1b's colour half runs
K1a's phases (``tests/test_torch_bc23_host_build.py``). The launch, the loads
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

from conftest import photo_rgba
from test_torch_bc7_host_build import CSRC, STUB, _to_blocks

HARNESS = r"""
#include "bc1_search.cuh"

#include <cstring>

// The shared structs of one block and its lanes' registers. With g_orders
// set, every phase runs twice from the same state: its lanes in descending
// order, then ascending. A phase in which one lane reads or writes what
// another lane writes in the same phase leaves two different states;
// g_races counts those phases.
struct HostState {
  bcx::Bc1Block b;
  bcx::Bc1Fit f[2];
  bcx::Bc1Lane r[bcx::BC1_LANES];
  bcx::Bc1Cube cube;
};
static HostState g_st, g_before, g_down;
static int g_orders = 0;
static long long g_races = 0;

// a phase of L lanes; call(f, lane) runs lane `lane` of it
template <int L, class F, class Call>
static void run_lanes(F&& f, Call&& call) {
  if (g_orders) {
    std::memcpy(&g_before, &g_st, sizeof(HostState));
    for (int lane = L - 1; lane >= 0; --lane) call(f, lane);
    std::memcpy(&g_down, &g_st, sizeof(HostState));
    std::memcpy(&g_st, &g_before, sizeof(HostState));
  }
  for (int lane = 0; lane < L; ++lane) call(f, lane);
  if (g_orders && std::memcmp(&g_down, &g_st, sizeof(HostState))) ++g_races;
}

// one mode: start, the refine or the cube, the final assign
template <bool FOUR, bool MASKED, bool B3D>
static void host_fit(bcx::Bc1Fit& f, const bcx::Bc1Budget& bud) {
  auto run = [](auto&& ph) {
    run_lanes<bcx::BC1_LANES>(ph, [](auto& p, int l) { p(l, g_st.r[l]); });
  };
  auto run32 = [](auto&& ph) {
    run_lanes<bcx::BC1_CUBE_LANES>(ph, [](auto& p, int l) { p(l); });
  };
  bcx::bc1_group_start<FOUR, MASKED>(g_st.b, f, bud, run);
  if (B3D) bcx::bc1_cube<FOUR, MASKED>(g_st.b, f, bud, g_st.cube, run32);
  else bcx::bc1_group_refine<FOUR, MASKED>(g_st.b, f, bud, run);
  bcx::bc1_group_assign<FOUR, MASKED>(g_st.b, f, run);
}

// block i of K1a: load, the 4-colour mode, the 3-colour mode, the race
template <bool MASKED, bool B3D>
static void host_block(const float* x, long long i, int C,
                       const bcx::Bc1Budget& bud, unsigned* words,
                       float* err) {
  auto run = [](auto&& ph) {
    run_lanes<bcx::BC1_LANES>(ph, [](auto& p, int l) { p(l, g_st.r[l]); });
  };
  bcx::bc1_group_load<MASKED>(g_st.b, x + i * 16 * C, C, bud, run);
  host_fit<true, MASKED, B3D>(g_st.f[0], bud);
  if (bud.allow_three) host_fit<false, MASKED, B3D>(g_st.f[1], bud);
  uint2 w;
  bcx::bc1_group_race<MASKED>(g_st.b, g_st.f[0],
                              bud.allow_three ? &g_st.f[1] : nullptr, w,
                              err[i]);
  words[2 * i] = w.x;
  words[2 * i + 1] = w.y;
}

static bcx::Bc1Budget budget(const float* w, int iters, int passes,
                             int allow_three, int use_alpha, float athr255,
                             int adaptive, int b3d) {
  bcx::Bc1Budget bud;
  for (int c = 0; c < 3; ++c) bud.w[c] = w[c];
  bud.iters = iters; bud.passes = passes; bud.allow_three = allow_three;
  bud.use_alpha = use_alpha; bud.athr255 = athr255;
  bud.adaptive = adaptive; bud.b3d = b3d;
  return bud;
}

// bc1_encode's contract, every phase as a loop over the lanes; with
// `orders`, each phase in both lane orders. Returns the number of phases
// whose two orders left different states.
extern "C" long long host_bc1(const float* x, long long n, int C,
                              const float* w, int iters, int passes,
                              int allow_three, int use_alpha, float athr255,
                              int adaptive, int b3d, int orders,
                              unsigned* words, float* err) {
  const bcx::Bc1Budget bud = budget(w, iters, passes, allow_three, use_alpha,
                                    athr255, adaptive, b3d);
  g_orders = orders;
  g_races = 0;
  std::memset(&g_st, 0, sizeof(HostState));
  for (long long i = 0; i < n; ++i) {
    if (use_alpha) {
      if (b3d) host_block<true, true>(x, i, C, bud, words, err);
      else host_block<true, false>(x, i, C, bud, words, err);
    } else {
      if (b3d) host_block<false, true>(x, i, C, bud, words, err);
      else host_block<false, false>(x, i, C, bud, words, err);
    }
  }
  g_orders = 0;
  return g_races;
}

// K1a's launch shape: lanes per (block, mode), blocks per CTA, lanes of
// the cube
extern "C" void host_bc1_shape(int* out) {
  out[0] = bcx::BC1_LANES;
  out[1] = bcx::BC1_CTA_BLOCKS;
  out[2] = bcx::BC1_CUBE_LANES;
}

// the one-thread search of K1c (4 colours, opaque) on RGBA blocks
extern "C" void host_bc1_one_thread(const float* x, long long n,
                                    const float* w, int iters, int passes,
                                    int adaptive, unsigned* words,
                                    float* err) {
  const bcx::Bc1Budget bud = budget(w, iters, passes, 0, 0, 0.0f, adaptive,
                                    0);
  for (long long i = 0; i < n; ++i) {
    float xs[3][16];
    bcx::load_block<3>(x + i * 64, 4, xs);
    uint32_t a0, a1, pidx;
    bcx::bc1_search(xs, bud, a0, a1, pidx, err[i]);
    words[2 * i] = a0 | (a1 << 16);
    words[2 * i + 1] = pidx;
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA search header for the host")
    d = tmp_path_factory.mktemp("bc1_host")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libbc1_host.so"
    r = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-fast-math",
         "-Wno-unknown-pragmas", "-shared", "-fPIC", "-I", str(d), "-I",
         str(CSRC), "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.host_bc1.argtypes = [p, ll, i, p, i, i, i, i, f, i, i, i, p, p]
    lib.host_bc1.restype = ll
    lib.host_bc1_one_thread.argtypes = [p, ll, p, i, i, i, p, p]
    lib.host_bc1_one_thread.restype = None
    lib.host_bc1_shape.argtypes = [p]
    lib.host_bc1_shape.restype = None
    return lib


def _blocks():
    """320 RGBA blocks: photo, noise, solid, two-colour, exact 0/1, one-level
    gradients, and alpha at, just below and far below the 128/255
    threshold (all-transparent blocks too)."""
    rng = np.random.default_rng(11)
    parts = [_to_blocks(photo_rgba(32, 64, seed=5)),                    # 128
             rng.random((56, 16, 4), np.float32),
             np.repeat(rng.random((24, 1, 4), np.float32), 16, 1)]
    c = rng.random((32, 2, 4), np.float32)
    pick = rng.integers(0, 2, (32, 16))
    parts.append(np.take_along_axis(c, pick[:, :, None].repeat(4, 2), 1))
    parts.append(rng.integers(0, 2, (24, 16, 4)).astype(np.float32))
    base = rng.integers(0, 255, (24, 1, 4))
    parts.append((base + rng.integers(0, 2, (24, 16, 1))) / 255.0)
    t = np.clip(np.repeat(rng.random((32, 1, 4), np.float32), 16, 1)
                + rng.normal(0, 0.03, (32, 16, 4)), 0, 1)
    t[..., 3] = np.where(rng.integers(0, 2, (32, 16)) > 0,
                         np.float32(128 / 255.0), np.float32(127 / 255.0))
    t[:4, :, 3] = 0.0
    parts.append(t)
    x = np.concatenate(parts).astype(np.float32)
    x[128:176:3, :, 3] *= 0.3
    assert x.shape == (320, 16, 4)
    return np.ascontiguousarray(x)


THR = 128 / 255.0
# chip_smoke.py's six BC1 budgets
BUDGETS = {
    "default": {},
    "use_alpha": {"use_alpha": True, "alpha_threshold": THR},
    "four_only": {"allow_three": False},
    "adaptive": {"adaptive": True},
    "b3d": {"b3d": True},
    "b3d_use_alpha": {"b3d": True, "use_alpha": True, "alpha_threshold": THR},
}


def _host(lib, x, kw, orders=False):
    """encode_bc1_blocks' contract through the host build of K1a; returns
    (words (N,2) uint32, err (N,), phases whose lane orders differ)."""
    k = dict(weights=bc1.PERCEPTUAL_WEIGHTS, iters=3, passes=1,
             allow_three=True, use_alpha=False, alpha_threshold=0.5,
             adaptive=False, b3d=False)
    k.update(kw)
    n, _, c = x.shape
    w = np.asarray(k["weights"], np.float32)
    words = np.zeros((n, 2), np.uint32)
    err = np.zeros((n,), np.float32)
    races = lib.host_bc1(
        x.ctypes.data, n, c, w.ctypes.data, k["iters"], k["passes"],
        int(k["allow_three"]), int(k["use_alpha"]),
        float(np.float32(k["alpha_threshold"] * 255.0)), int(k["adaptive"]),
        int(k["b3d"]), int(orders), words.ctypes.data, err.ctypes.data)
    return words, err, races


def _plain(x, kw):
    wp, ep = bc1.encode_bc1_blocks_plain(torch.from_numpy(x), **kw)
    return wp.numpy().view(np.uint32), ep.numpy()


@pytest.mark.parametrize("budget", list(BUDGETS))
def test_host_built_bc1_search_equals_plain_version(host_lib, budget):
    x = _blocks()
    if BUDGETS[budget].get("b3d"):
        x = x[::4].copy()       # the cube is 729 candidates per mode
    wh, eh, _ = _host(host_lib, x, BUDGETS[budget])
    wp, ep = _plain(x, BUDGETS[budget])
    same = (wh == wp).all(axis=1)
    assert same.all(), f"{(~same).sum()} of {same.size} blocks differ"
    np.testing.assert_array_equal(eh, ep)


@pytest.mark.parametrize("budget", ["default", "use_alpha", "b3d_use_alpha"])
def test_bc1_phases_do_not_depend_on_lane_order(host_lib, budget):
    """Every phase of K1a's search leaves the same shared state and lane
    registers with its lanes run in descending as in ascending order, so no
    lane reads or writes another lane's data within a phase; the words and
    errors are the plain version's."""
    x = _blocks()[::2].copy()
    if BUDGETS[budget].get("b3d"):
        x = x[::4].copy()
    wh, eh, races = _host(host_lib, x, BUDGETS[budget], orders=True)
    assert races == 0, f"{races} phases depend on the order of their lanes"
    wp, ep = _plain(x, BUDGETS[budget])
    np.testing.assert_array_equal(wh, wp)
    np.testing.assert_array_equal(eh, ep)


@pytest.mark.parametrize("kw", [{}, {"passes": 2}, {"adaptive": True}],
                         ids=["default", "passes2", "adaptive"])
def test_host_built_one_thread_search_equals_plain_version(host_lib, kw):
    """The one-thread search that K1c runs for its colour half: 4 colours,
    opaque."""
    x = _blocks()
    k = dict(iters=3, passes=1, adaptive=False)
    k.update(kw)
    n = x.shape[0]
    w = np.asarray(bc1.PERCEPTUAL_WEIGHTS, np.float32)
    words = np.zeros((n, 2), np.uint32)
    err = np.zeros((n,), np.float32)
    host_lib.host_bc1_one_thread(x.ctypes.data, n, w.ctypes.data, k["iters"],
                                 k["passes"], int(k["adaptive"]),
                                 words.ctypes.data, err.ctypes.data)
    wp, ep = _plain(x, dict(allow_three=False, **kw))
    np.testing.assert_array_equal(words, wp)
    np.testing.assert_array_equal(err, ep)


def test_bc1_launch_shape_is_the_wrappers(host_lib):
    """The header's lanes per (block, mode), blocks per CTA and lanes of
    the cube are what ``bc1.BC1_LANES``, ``bc1.BC1_CTA_BLOCKS`` and
    ``bc1.BC1_CUBE_LANES`` report, a CTA of both modes is whole warps, and
    the cube runs on a whole warp."""
    out = np.zeros(3, np.int32)
    host_lib.host_bc1_shape(out.ctypes.data)
    assert tuple(int(v) for v in out) == (bc1.BC1_LANES, bc1.BC1_CTA_BLOCKS,
                                          bc1.BC1_CUBE_LANES)
    assert bc1.BC1_CUBE_LANES == 32
    assert 32 % bc1.BC1_LANES == 0 and 16 % bc1.BC1_LANES == 0
    assert (bc1.BC1_CTA_BLOCKS * bc1.BC1_LANES) % 32 == 0
