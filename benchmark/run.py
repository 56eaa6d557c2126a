"""One run of one cell of the port's benchmark, on one NVIDIA GPU.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; their files, and a reader for each metric,
are found by name (``spec.py``). Set-up makes the sources from the seed on
the card, loads the program's kernels (building them into ``build/kernels/``
of the checkout on the first run) and warms every shape of the cell; the
window then drives ``gfx_imagecompress_tpu_torch.api.compress`` for
``--seconds``. After it, the words the calls emitted are compared with the
plain reference (``check.py``) and the PSNR is taken.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; ``checks``, last, holds each number compared beside its
limit, which also end standard error. Without a CUDA device, or with fewer
than the cell asks for, it prints no result and exits 2; where ``jax``,
``jaxlib``, ``flax`` or the JAX package is loaded, it exits 3.
"""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # run as a script: import the benchmark and the program from the root
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from benchmark import check, spec  # noqa: E402
from benchmark.devtrace import Tracer  # noqa: E402
from benchmark.pipe import Pipe, clock  # noqa: E402
from benchmark.record import Run  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gfx_imagecompress_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from /proc, to
    10 ms), or the harness's import where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return clock() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def program_encode(fast: bool, device):
    """The system under test: one ``compress`` call on a uint8 texture that
    lies on the card."""
    from gfx_imagecompress_tpu_torch.api import compress
    from gfx_imagecompress_tpu_torch.formats import CompressType
    from gfx_imagecompress_tpu_torch.image import Image

    def encode(u8):
        return compress(CompressType.DXBC7, Image.from_array(u8, device=device),
                        fast=fast)
    return encode


def program_counters():
    """(reset, read) of the program's kernel launch counters; read gives the
    launches of each kernel."""
    from gfx_imagecompress_tpu_torch import kernels
    return kernels.reset_launch_counts, kernels.launch_counts


def card(device) -> dict:
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
         "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        d["power_limit"] = smi[torch.device(device).index or 0].split(",")[
            -1].strip()
    except (OSError, subprocess.TimeoutExpired, IndexError):
        d["power_limit"] = "not read"
    return d


def run_cell(cell, seed: int, seconds: float, trace: bool, device, encode,
             counters=None, t_start: float = None):
    """Everything of a run after the look for a chip: set-up, the window,
    the comparison and the metrics. ``encode`` is the system under test;
    ``counters`` (reset, read) its launch counters. Returns (result without
    ``device``, Run)."""
    t_start = T_IMPORT if t_start is None else t_start
    enc = spec.encoder(cell.config["encoder"])
    opts = enc.options(cell.config)
    pipe = Pipe(device, trace)
    loop = spec.loop(cell.mix["loop"]).make(cell.mix, seed, pipe, enc, opts,
                                            seconds)
    levels = loop.levels()
    below = sum(lv.stats["alpha_below_1"] for lv in levels)
    log(f"inputs: {len(levels)} source levels, "
        f"{sum(lv.blocks for lv in levels)} blocks, "
        f"{100.0 * below / sum(lv.blocks for lv in levels):.3f}% of them "
        "with some alpha below 1")
    tracer = Tracer(trace)
    tracer.start()
    loop.warm(encode)
    if counters:
        counters[0]()
    run = Run(cell.name, seed, seconds)
    pipe.sync()
    # what set-up left is kept out of the collector's later passes, so that
    # none of them pauses the window for long
    gc.collect()
    gc.freeze()
    run.setup_s = clock() - t_start
    pipe.spans.clear()
    tracer.open()
    loop.window(encode, seconds, run)
    t_trace = clock()
    run.trace = tracer.stop(pipe.spans)
    gc.unfreeze()
    if trace:
        log(f"trace: {clock() - t_trace:.3f} s to stop, write and read")
        log("longest idle gaps: " + "; ".join(
            f"{n} at {a:.3f} s for {1e3 * d:.3f} ms"
            for n, a, d in run.trace.gaps(5)))
        (dn, da), (hn, ha) = run.trace.first()
        log(f"window opened: marker launched in {1e3 * tracer.launch_s:.3f} "
            f"ms; first on the card {dn} at {1e3 * da:.3f} ms, first host "
            f"span {hn} at {1e3 * ha:.3f} ms")
        log("longest CUDA API calls: " + "; ".join(
            f"{n} at {a:.3f} s for {1e3 * d:.3f} ms"
            for n, a, d in run.trace.longest_calls(5)))
    pipe.sync()
    if counters:
        launches = counters[1]()
        run.launches = sum(launches.values())
        lost = run.trace.missing(launches) if run.trace is not None else []
        if lost:
            raise RuntimeError(
                "devtrace: the trace holds fewer of the window's kernels "
                "than the program launched (kernel, traced, launched): "
                f"{lost}")
    peak = torch.cuda.max_memory_allocated(device) if pipe.cuda else 0
    del loop
    if pipe.cuda:
        torch.cuda.empty_cache()
    t_psnr = clock()
    run.psnr_db = check.psnr(run.psnr_pairs, run.psnr_channels, device)
    t_check = clock()
    nums = check.numbers(run, enc, opts, device)
    log(f"phases: set-up {run.setup_s:.3f} s, window {run.window_s:.3f} s, "
        f"psnr {t_check - t_psnr:.3f} s, reference {clock() - t_check:.3f} s"
        f" on {nums['blocks']} blocks")
    checks = check.verdict(nums, cell.limits)
    def read(entries):
        out = {}
        for m in entries:
            v = spec.reader(m["name"]).read(run)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out

    metrics = read(cell.per_layer if trace else cell.end_to_end)
    failed = sum(1 for it in run.items if it.failed)
    result = {"correct": check.correct(checks), "attempted": len(run.items),
              "failed": failed, "metrics": metrics,
              "memory_peak_bytes": peak,
              "info": {"calls": len(run.calls),
                       "failed_calls": sum(1 for c in run.calls if c.failed),
                       "sampled_blocks": nums["blocks"],
                       "words_differ": nums["words_differ"],
                       "window_s": run.window_s,
                       "psnr_db": run.psnr_db if math.isfinite(
                           run.psnr_db) else None,
                       "launches": run.launches}}
    if not trace:
        # the host-clock and counter readings of the per-layer metrics,
        # without the profiler: beside a traced run's, its cost
        result["info"]["per_layer"] = {
            k: v["value"] for k, v in read(cell.per_layer).items()}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    for note in run.notes[:3]:
        log("failed call:", note)
    return result, run


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"run: the cell needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count() {torch.cuda.device_count()}")
        return 2
    found = forbidden_modules()
    if found:
        log(f"run: loaded before the run: {found}")
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from gfx_imagecompress_tpu_torch.kernels import _build
    info = _build.ensure_built()
    log(f"build: {info['seconds']:.3f} s, built {info['built']}")
    enc = spec.encoder(cell.config["encoder"])
    result, run = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device, program_encode(enc.FAST, device),
                           program_counters(), t_start)
    found = forbidden_modules()
    if found:
        log(f"run: loaded once the window had closed: {found}")
        return 3
    dev = card(device)
    dev["memory_peak_bytes"] = result.pop("memory_peak_bytes")
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    checks = result.pop("checks")
    result["device"] = dev
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
