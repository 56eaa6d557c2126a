"""Builds and loads the CUDA kernels at first use.

Each source under ``csrc/`` with a plain C interface is compiled by its own
``nvcc`` (all started together) into a shared library under ``build/kernels/``
at the root of the checkout and loaded with ``ctypes``. No source includes
PyTorch's headers, so there is no binding file to compile and every ``nvcc``
call sees only the kernel's own code. A library is named after the hash of its sources and flags, so a
later process reuses it and an edit rebuilds it.

Flags: ``sm_90a``, ``-O3``, ``-fmad=false`` and no fast math. The searches
decide between candidates with strict compares on sums of squares, so the
kernels keep IEEE ``+ - * /`` and ``sqrtf`` un-contracted, as the plain
PyTorch versions compute them; with contraction a tie can flip and the words
differ while the error does not.

A kernel's C function launches on the stream it is given, does not
synchronise, allocates nothing and returns ``cudaGetLastError()``;
``launch`` raises if that is not 0. A failed build raises too. Nothing here
falls back to another implementation.

This module is imported only from inside the wrappers' CUDA branch, so the
package imports on a machine that has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
HEADERS = ("bcx_common.cuh", "bc1_search.cuh", "bc4_search.cuh",
           "bc23_group.cuh", "bc45_group.cuh",
           "bc7_common.cuh", "bc7_est.cuh", "bc7_group.cuh",
           "bc7_fast_search.cuh", "bc7_full_search.cuh", "bc6h_layouts.cuh",
           "bc6h_search.cuh")
_BC7_FULL = ("bcx_common.cuh", "bc7_common.cuh", "bc7_group.cuh",
             "bc7_full_search.cuh")
# library -> (source, headers it includes)
SOURCES = {
    "bc1": ("bc1_kernel.cu", ("bcx_common.cuh", "bc1_search.cuh")),
    "bc23": ("bc23_kernels.cu",
             ("bcx_common.cuh", "bc1_search.cuh", "bc4_search.cuh",
              "bc23_group.cuh")),
    "bc45": ("bc45_kernels.cu",
             ("bcx_common.cuh", "bc4_search.cuh", "bc45_group.cuh")),
    "bc7_est": ("bc7_est_kernel.cu",
                ("bcx_common.cuh", "bc7_common.cuh", "bc7_est.cuh")),
    "bc7_fast": ("bc7_fast_kernel.cu",
                 ("bcx_common.cuh", "bc7_common.cuh", "bc7_group.cuh",
                  "bc7_fast_search.cuh")),
    "bc7_full_m02": ("bc7_full_m02_kernel.cu", _BC7_FULL),
    "bc7_full_m1367": ("bc7_full_m1367_kernel.cu", _BC7_FULL),
    "bc7_full_m45": ("bc7_full_m45_kernel.cu", _BC7_FULL),
    "bc6h": ("bc6h_kernel.cu", ("bcx_common.cuh", "bc7_common.cuh",
                                "bc7_group.cuh", "bc6h_layouts.cuh",
                                "bc6h_search.cuh")),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _L, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                  ctypes.c_float)
# C function -> (library, argument types before the trailing stream pointer)
FUNCTIONS = {
    "bc1_encode": ("bc1", (_P, _L, _I, _P, _P, _F, _F, _F, _I, _I, _I, _I,
                           _F, _I, _I)),
    "bc3_encode": ("bc23", (_P, _L, _P, _P, _F, _F, _F, _I, _I, _I, _I, _I,
                            _I)),
    "bc2_encode": ("bc23", (_P, _L, _P, _P, _F, _F, _F, _I, _I, _I)),
    "bc4_encode": ("bc45", (_P, _L, _P, _P, _I, _I, _I)),
    "bc5_encode": ("bc45", (_P, _L, _I, _P, _P, _I, _I, _I)),
    "bc7_est_topk": ("bc7_est", (_P, _L, _I, _I, _P, _P, _I, _I, _I, _I,
                                   _P, _P)),
    "bc7_fast_encode": ("bc7_fast", (_P, _L, _P, _I, _I, _I, _P, _P)),
    **{fn: (fn, (_P, _L, _I, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P))
       for fn in ("bc7_full_m02", "bc7_full_m1367", "bc7_full_m45")},
    "bc6h_encode": ("bc6h", (_P, _L, _I, _I, _I, _I, _I, _I, _P, _P)),
}

_lock = threading.Lock()
_libs: dict = {}
_info = {"seconds": None, "built": [], "ptxas": {}}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _digest(source: str, headers) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source, *headers):
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build_all() -> None:
    """Compile every library that is not in the build directory yet, one
    nvcc each, all at once; then load them all."""
    t0 = time.perf_counter()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets, procs = {}, {}
    for lib, (source, headers) in SOURCES.items():
        so = out_dir / f"{lib}-{_digest(source, headers)}.so"
        targets[lib] = so
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / source)]
            procs[lib] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    failures = []
    for lib, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{lib}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {SOURCES[lib][0]} "
                            f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, targets[lib])
            _info["built"].append(lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    for lib, so in targets.items():
        _libs[lib] = ctypes.CDLL(str(so))
        log = out_dir / f"{lib}.ptxas.txt"
        _info["ptxas"][lib] = log.read_text() if log.exists() else ""
    for name, (lib, argtypes) in FUNCTIONS.items():
        fn = getattr(_libs[lib], name)
        fn.argtypes = [*argtypes, _P]
        fn.restype = _I
    _info["seconds"] = time.perf_counter() - t0


def ensure_built() -> dict:
    """Build (if needed) and load the kernels; returns build information:
    ``seconds``, the libraries ``built`` by this process and the compiler's
    ``ptxas`` resource report per library."""
    with _lock:
        if not _libs:
            _build_all()
    return _info


def launch(name: str, *args) -> None:
    """Call the C function ``name`` on the current stream. Tensors are passed
    by their data pointer; a ctypes array (a short host-side list) passes as
    it is, None as a null pointer. Raises if the launch is refused."""
    ensure_built()
    lib, _ = FUNCTIONS[name]
    fn = getattr(_libs[lib], name)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*cargs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")
