"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to run on the CPU unasked, and the CUDA sources its
build module names exist."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gfx_imagecompress_tpu_torch as tgic

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "gfx_imagecompress_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|gfx_imagecompress_tpu)(?:[.\s]|$)", re.M)


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_has_the_expected_modules():
    names = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"__init__.py", "api.py", "image.py", "formats.py", "options.py",
            "bitpack.py", "convert.py", "pipeline/blocks.py",
            "decode/bcn.py", "decode/__init__.py", "kernels/bc1.py",
            "kernels/bc4.py", "kernels/_build.py", "io/dds.py",
            "bitpack_dyn.py", "decode/bc7.py", "tables/__init__.py",
            "tables/bc7_tables.py", "kernels/bc7_est.py",
            "kernels/bc7_fast.py", "kernels/bc7_full.py",
            "pipeline/chunking.py", "tables/bc6h_tables.py",
            "decode/bc6h.py", "kernels/bc6h.py",
            "csrc/gen_bc6h_layouts.py", "blockapi.py", "native.py",
            "bench_quality.py", "dist/__init__.py", "dist/sharded.py",
            "refcpu/__init__.py", "refcpu/corpus.py", "refcpu/bcx_amd.py",
            "refcpu/bc7enc16.py", "refcpu/bc7_amd.py",
            "refcpu/bc6h_amd.py", "bench.py", "roofline.py"} <= names


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_import_of_jax_or_the_jax_package(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_forbidden_pattern_catches_what_it_should():
    assert FORBIDDEN.search("import jax\n")
    assert FORBIDDEN.search("  from jax.numpy import x\n")
    assert FORBIDDEN.search("from gfx_imagecompress_tpu.formats import X\n")
    assert FORBIDDEN.search("import gfx_imagecompress_tpu\n")
    assert not FORBIDDEN.search("import gfx_imagecompress_tpu_torch as g\n")
    assert not FORBIDDEN.search("from gfx_imagecompress_tpu_torch import a\n")
    assert not FORBIDDEN.search("# like the jax package\n")


def test_runs_with_jax_and_the_jax_package_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gfx_imagecompress_tpu'] = None\n"
        "import numpy as np\n"
        "import gfx_imagecompress_tpu_torch as gic\n"
        "from gfx_imagecompress_tpu_torch import convert, kernels\n"
        "from gfx_imagecompress_tpu_torch import bench_quality, blockapi\n"
        "from gfx_imagecompress_tpu_torch import bench, roofline\n"
        "from gfx_imagecompress_tpu_torch import native\n"
        "from gfx_imagecompress_tpu_torch.dist import sharded\n"
        "from gfx_imagecompress_tpu_torch.refcpu import (bc6h_amd, bc7_amd,\n"
        "    bc7enc16, bcx_amd, corpus)\n"
        "from gfx_imagecompress_tpu_torch.decode import decode_image\n"
        "from gfx_imagecompress_tpu_torch.io import dds\n"
        "arr = np.random.default_rng(0).random((8, 12, 4), dtype=np.float32)\n"
        "img = gic.Image.from_array(arr, device='cpu')\n"
        "for ct in (gic.CompressType.DXBC1, gic.CompressType.DXBC3,\n"
        "           gic.CompressType.DXBC5):\n"
        "    out = gic.compress(ct, img)\n"
        "    assert decode_image(out).shape[:3] == (1, 8, 12)\n"
        "out = gic.compress_richgel999_bc7(\n"
        "    img, gic.RichGel999Options(fast=True))\n"
        "assert decode_image(out).shape == (1, 8, 12, 4)\n"
        "hdr = gic.Image.from_array(arr * 9.0, hdr=True, device='cpu')\n"
        "out = gic.compress(gic.CompressType.DXBC6H, hdr)\n"
        "assert decode_image(out).shape == (1, 8, 12, 3)\n"
        "b = np.asarray(out.blocks).reshape(-1, 4)\n"
        "assert native.decode_bc6h(b).shape == (b.shape[0], 16, 3)\n"
        "w = blockapi.compress_bc1_blocks(arr[:4].reshape(3, 16, 4),\n"
        "                                 device='cpu')\n"
        "assert tuple(w.shape) == (3, 2)\n"
        "import runpy\n"
        "runpy.run_path('gfx_imagecompress_tpu_torch/csrc/"
        "gen_bc6h_layouts.py', run_name='gen')\n"
        "assert sum(kernels.launch_counts().values()) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       if sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")


def test_device_none_means_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    import numpy as np
    from gfx_imagecompress_tpu_torch import convert
    arr = np.zeros((4, 4, 4), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        tgic.Image.from_array(arr)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.image_from_reference(arr)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.compressed_from_reference(
            np.zeros((1, 1, 1, 2), np.uint32), "BC1_UNORM", 4, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        tgic.Image.from_array(arr, device="cuda:0")


def test_cpu_wrappers_never_touch_the_build_module():
    """On a CPU tensor a wrapper takes the plain version and counts no
    launch; the build module is not even imported."""
    import numpy as np
    from gfx_imagecompress_tpu_torch import kernels
    kernels.reset_launch_counts()
    img = tgic.Image.from_array(
        np.random.default_rng(1).random((4, 4, 4), dtype=np.float32),
        device="cpu")
    for ct in ("DXBC1", "DXBC2", "DXBC3", "DXBC4", "DXBC5"):
        assert tgic.compress(tgic.CompressType[ct], img) is not None
    assert tgic.compress(tgic.CompressType.DXBC7, img, fast=True) is not None
    assert tgic.compress(tgic.CompressType.DXBC7, img) is not None
    hdr = tgic.Image.from_array(img.data * 9.0, signed=True, hdr=True,
                                device="cpu")
    assert tgic.compress(tgic.CompressType.DXBC6H, hdr) is not None
    assert kernels.launch_counts() == {
        "bc1": 0, "bc2": 0, "bc3": 0, "bc4": 0, "bc5": 0, "bc7_est": 0,
        "bc7_fast": 0, "bc7_full": 0, "bc6h": 0}


def test_shortlist_counts_by_configuration_only_on_a_launch():
    """A shortlist on a CPU tensor adds nothing to the per-configuration
    counts; the key cuts ``k`` to the partitions, as the wrapper does."""
    import numpy as np
    from gfx_imagecompress_tpu_torch import kernels
    from gfx_imagecompress_tpu_torch.kernels import bc7_est
    kernels.reset_launch_counts()
    x = torch.from_numpy(
        np.random.default_rng(2).random((4, 16, 4), dtype=np.float32))
    ids = bc7_est.estimate_topk(x, chans=3, subsets=2, plist=(0, 3, 7),
                                levels=8, k=5)
    assert ids.shape == (4, 3)
    assert bc7_est.LAUNCHES_BY_CONFIG == {}
    assert bc7_est.config_key(3, 2, (0, 3, 7), 8, 5) == (3, 2, 3, 8, 3,
                                                          "bounds")
    assert bc7_est.config_key(4, 2, range(64), 4, 8, "pca") == (
        4, 2, 64, 4, 8, "pca")


def test_build_module_names_sources_that_exist():
    from gfx_imagecompress_tpu_torch.kernels import _build
    assert _build.CSRC == PKG / "csrc"
    named = set(_build.HEADERS)
    for source, headers in _build.SOURCES.values():
        named |= {source, *headers}
    for name in named:
        assert (_build.CSRC / name).is_file(), name
    on_disk = {p.name for p in _build.CSRC.iterdir()
               if p.suffix in (".cu", ".cuh")}
    assert on_disk == named
    # every header a source includes is in its dependency list (the list
    # feeds the rebuild hash)
    def includes(name, seen):
        for inc in re.findall(r'#include "([^"]+)"',
                              (_build.CSRC / name).read_text()):
            if inc not in seen:
                seen.add(inc)
                includes(inc, seen)
        return seen

    for source, headers in _build.SOURCES.values():
        assert includes(source, set()) == set(headers), source
    libs = {lib for lib, _ in _build.FUNCTIONS.values()}
    assert libs == set(_build.SOURCES)
    for fn, (lib, _) in _build.FUNCTIONS.items():
        text = (_build.CSRC / _build.SOURCES[lib][0]).read_text()
        assert re.search(rf'extern "C" int {fn}\(', text), fn
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def test_c_signatures_match_the_argument_tables():
    """ctypes cuts a pointer it is not told about: the argument-type table
    must follow each C function's parameter list."""
    import ctypes
    from gfx_imagecompress_tpu_torch.kernels import _build
    kinds = {"const float*": ctypes.c_void_p, "uint32_t*": ctypes.c_void_p,
             "float*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "const int*": ctypes.c_void_p, "int*": ctypes.c_void_p,
             "const uint8_t*": ctypes.c_void_p,
             "long long": ctypes.c_longlong, "int": ctypes.c_int,
             "float": ctypes.c_float}
    for fn, (lib, argtypes) in _build.FUNCTIONS.items():
        text = (_build.CSRC / _build.SOURCES[lib][0]).read_text()
        params = re.search(rf'extern "C" int {fn}\((.*?)\)\s*\{{', text,
                           re.S).group(1)
        got = []
        for p in params.split(","):
            ty = " ".join(p.split()[:-1])
            got.append(kinds[ty])
        assert got == [*argtypes, ctypes.c_void_p], fn


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
