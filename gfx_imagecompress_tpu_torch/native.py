"""ctypes loader for the native BCn decode oracle (``csrc/bcn_decode.cpp``).

The oracle is an independent decoder written from the format specs, in C++.
Tests and ``chip_smoke.py`` hold the PyTorch decoders (``decode/``) against
it, so a misreading of the spec shared by the port's encoder and decoder
cannot survive both.

At first use the source is compiled with ``g++ -O2 -fPIC -shared`` into
``build/native/`` at the root of the checkout, under a name that hashes the
source, its layouts include and the flags: a later process reuses it and an
edit rebuilds it. No binary is committed. A failed build raises; nothing
falls back to another decoder.

Every function takes packed words (``(N, W)`` uint32 numpy words, or the
port's int32 word storage as a tensor on any device) and returns numpy
arrays on the host.
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

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("bcn_decode.cpp", "bc6h_layouts.inc")
CXX_FLAGS = ("-O2", "-fPIC", "-shared")

_lock = threading.Lock()
_state = {"lib": None, "seconds": None, "built": False, "path": None}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[1] / "build" / "native"


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libbcn_decode-{_digest()}.so"
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native decode oracle cannot be "
                           "built")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                        str(CSRC / "bcn_decode.cpp")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for bcn_decode.cpp (exit "
                           f"{r.returncode}):\n{r.stdout}{r.stderr}")
    # atomic: two processes that build at once both land the same library
    os.replace(tmp, so)
    _state["built"] = True
    return so


def ensure_built() -> dict:
    """Build (if needed) and load the oracle; returns ``seconds`` (this
    process's build and load time), ``built`` (whether this process
    compiled it) and the library's ``path``."""
    with _lock:
        if _state["lib"] is None:
            t0 = time.perf_counter()
            so = _build()
            lib = ctypes.CDLL(str(so))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u16p = ctypes.POINTER(ctypes.c_uint16)
            for name, args in (
                    ("decode_bc1", (u8p, u8p, ctypes.c_int, ctypes.c_int)),
                    ("decode_bc2", (u8p, u8p, ctypes.c_int)),
                    ("decode_bc3", (u8p, u8p, ctypes.c_int)),
                    ("decode_bc4", (u8p, u8p, ctypes.c_int)),
                    ("decode_bc5", (u8p, u8p, ctypes.c_int)),
                    ("decode_bc7", (u8p, u8p, ctypes.c_int)),
                    ("decode_bc6h", (u8p, u16p, ctypes.c_int, ctypes.c_int))):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = None
            _state.update(lib=lib, path=str(so),
                          seconds=time.perf_counter() - t0)
    return {k: _state[k] for k in ("seconds", "built", "path")}


def _lib():
    ensure_built()
    return _state["lib"]


def _as_bytes(words) -> np.ndarray:
    if hasattr(words, "detach"):                   # the port's word storage
        words = words.detach().cpu().contiguous().numpy().view(np.uint32)
    w = np.ascontiguousarray(np.asarray(words), dtype="<u4")
    return w.view(np.uint8).reshape(w.shape[0], -1)


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_bc1(words, force_four: bool = False) -> np.ndarray:
    """(N,2) words -> (N,16,4) uint8 RGBA."""
    blk = _as_bytes(words)
    n = blk.shape[0]
    out = np.empty((n, 16, 4), np.uint8)
    _lib().decode_bc1(_u8p(blk), _u8p(out), n, int(force_four))
    return out


def decode_bc2(words) -> np.ndarray:
    """(N,4) words -> (N,16,4) uint8 RGBA."""
    blk = _as_bytes(words)
    n = blk.shape[0]
    out = np.empty((n, 16, 4), np.uint8)
    _lib().decode_bc2(_u8p(blk), _u8p(out), n)
    return out


def decode_bc3(words) -> np.ndarray:
    """(N,4) words -> (N,16,4) uint8 RGBA."""
    blk = _as_bytes(words)
    n = blk.shape[0]
    out = np.empty((n, 16, 4), np.uint8)
    _lib().decode_bc3(_u8p(blk), _u8p(out), n)
    return out


def decode_bc4(words) -> np.ndarray:
    """(N,2) words -> (N,16) uint8."""
    blk = _as_bytes(words)
    n = blk.shape[0]
    out = np.empty((n, 16), np.uint8)
    _lib().decode_bc4(_u8p(blk), _u8p(out), n)
    return out


def decode_bc5(words) -> np.ndarray:
    """(N,4) words -> (N,16,2) uint8."""
    blk = _as_bytes(words)
    n = blk.shape[0]
    out = np.empty((n, 16, 2), np.uint8)
    _lib().decode_bc5(_u8p(blk), _u8p(out), n)
    return out


def decode_bc7(words) -> np.ndarray:
    """(N,4) words -> (N,16,4) uint8 RGBA."""
    blk = _as_bytes(words)
    n = blk.shape[0]
    out = np.empty((n, 16, 4), np.uint8)
    _lib().decode_bc7(_u8p(blk), _u8p(out), n)
    return out


def decode_bc6h(words, signed: bool = False) -> np.ndarray:
    """(N,4) words -> (N,16,3) uint16 half-float bit patterns."""
    blk = _as_bytes(words)
    n = blk.shape[0]
    out = np.empty((n, 16, 3), np.uint16)
    _lib().decode_bc6h(
        _u8p(blk), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        n, int(signed))
    return out
