"""What the port's in-turns timing scripts share (``torch_bc1_est_timing.py``,
``torch_bc7_full_timing.py``, ``torch_bc6h_bc7fast_timing.py``): each builds
some kernels of this checkout and of another copy of the port's ``csrc/``
(``--parent``, for example an earlier commit's
``gfx_imagecompress_tpu_torch/csrc`` unpacked with ``git archive``) side by
side with the port's nvcc flags, calls them through their C functions on the
same inputs on one card, compares their outputs and times every side in
turns: each side in order, then in reverse (old, new, new, old), so that each
side has two readings, taken early and late. A module of helpers, not a
script; it needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_summary  # noqa: E402
from gfx_imagecompress_tpu_torch.kernels import _build  # noqa: E402


def arguments(doc: str) -> argparse.ArgumentParser:
    """The options every such script takes: ``--parent``, ``--reps`` and
    ``--out``; a script adds its own before parsing."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the other copy of gfx_imagecompress_tpu_torch/csrc")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    return ap


def device() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None
    without a CUDA device."""
    if not torch.cuda.is_available():
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def start_build(csrc: Path, name: str, sources: dict, flags=()):
    """Starts one nvcc per library (``sources``: library -> its ``.cu``
    file, relative to ``csrc`` unless absolute) with the port's flags,
    ``-I csrc`` and ``flags``, all at once, into ``build/turns/<name>/``.
    Returns a function that waits for them and returns (library ->
    ``ctypes.CDLL``, the ptxas resources of every kernel); it raises if one
    failed."""
    csrc = Path(csrc).resolve()
    out = ROOT / "build" / "turns" / name
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lib, src in sources.items():
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(csrc),
               "-o", str(out / f"{lib}.so"), str(csrc / src)]
        procs[lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)

    def wait():
        logs = {}
        for lib, proc in procs.items():
            logs[lib], _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}/{lib} ({csrc}, "
                                   f"{list(flags)}):\n{logs[lib]}")
        return ({lib: ctypes.CDLL(str(out / f"{lib}.so")) for lib in procs},
                ptxas_summary(logs))
    return wait


def function(libs: dict, name: str, argtypes=None):
    """The C function ``name`` of the built ``libs``, with the argument types
    ``_build.FUNCTIONS`` gives it (or ``argtypes``) and the trailing stream
    pointer."""
    lib, known = _build.FUNCTIONS[name]
    fn = getattr(libs[lib], name)
    fn.argtypes = [*(known if argtypes is None else argtypes),
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(fn, *args) -> None:
    """``fn`` on the current stream; tensors pass by their data pointer.
    Raises if the launch is refused."""
    rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{fn.__name__} failed ({rc})")


@contextmanager
def port_libraries(libs: dict):
    """Routes the port's own launches (``compress()`` and the wrappers)
    through ``libs`` (library -> ``ctypes.CDLL``, another side's build of
    some of ``_build.SOURCES``) until the block ends."""
    _build.ensure_built()
    saved = dict(_build._libs)
    for name, (lib, _) in _build.FUNCTIONS.items():
        if lib in libs:
            function(libs, name)
    _build._libs.update(libs)
    try:
        yield
    finally:
        _build._libs.clear()
        _build._libs.update(saved)


def in_turns(names, measure) -> dict:
    """``measure(name)`` for every side in ``names`` in order and then in
    reverse; returns side -> its two readings."""
    out = {s: [] for s in names}
    for s in [*names, *names[::-1]]:
        out[s].append(measure(s))
    return out


def blocks_differing(ref, got) -> int:
    """The number of rows (blocks) where any tensor of ``got`` differs from
    the same tensor of ``ref``."""
    bad = None
    for a, b in zip(ref, got):
        d = (a != b).reshape(a.shape[0], -1).any(dim=1)
        bad = d if bad is None else bad | d
    return int(bad.sum())


def finish(res: dict, out: str | None, ok: bool) -> int:
    """Prints the card and the results (without the ptxas logs), writes them
    all to ``out`` if given; returns the exit code."""
    print(res.get("device"), flush=True)
    print(json.dumps({k: v for k, v in res.items() if k != "resources"}),
          flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(res, indent=1))
    return 0 if ok else 1
