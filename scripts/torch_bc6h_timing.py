"""Times the PyTorch/CUDA port's BC6H search (K6) in the contexts a caller
meets it, on the 1024x1024 HDR fixture of ``chip_smoke.py``.

Each context runs ``--reps`` iterations; a CUDA event pair around each K6
launch gives its own time (median and mean), a pair around the whole loop
the time per iteration, and ``nvidia-smi`` samples the SM clock and the power
draw while the loop runs (where it can):

- ``alone``: K6 back to back on one tensor of half-ints;
- ``after_copy``: a device copy of the half-ints, then K6 on the copy;
- ``after_conversion``: the half conversion (``f32_to_half_int``), then K6 on
  its output, as ``encode_bc6h_blocks`` runs them;
- ``after_clone``: a clone of the half-ints (a new allocation each time),
  then K6 on the clone;
- ``conversion_then_fixed``: the half conversion, then K6 on the first
  tensor of half-ints (not the conversion's output);
- ``after_flush``: 128 MiB written (more than the L2 cache holds), then
  K6 on the first tensor of half-ints;
- ``after_sleep``: a device spin of ``--sleep-cycles`` that touches no memory,
  then K6 on the same tensor;
- ``compress``: ``compress(DXBC6H)`` on the image (the loop time only).

Needs a CUDA device. Run from the root of the repo:

    python3 scripts/torch_bc6h_timing.py [--reps 600] [--out results.json]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import photo_rgba  # noqa: E402
import gfx_imagecompress_tpu_torch as gic  # noqa: E402
from gfx_imagecompress_tpu_torch.kernels import bc6h  # noqa: E402
from gfx_imagecompress_tpu_torch.pipeline.blocks import (  # noqa: E402
    image_to_blocks)

SMI = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
       "--format=csv,noheader,nounits"]


def sampled(loop):
    """Runs ``loop()`` (which synchronises) while a thread queries
    ``nvidia-smi`` one shot after another; returns the median SM clock (MHz)
    and power draw (W) of the queries made inside the loop, or None where
    none were."""
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            t = time.perf_counter()
            try:
                r = subprocess.run(SMI, capture_output=True, text=True,
                                   timeout=10)
                c, w = (float(v) for v in r.stdout.split(","))
            except (OSError, ValueError, subprocess.SubprocessError):
                return
            samples.append(((t + time.perf_counter()) / 2, c, w))

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    time.sleep(0.5)
    t0 = time.perf_counter()
    loop()
    t1 = time.perf_counter()
    stop.set()
    th.join(timeout=15)
    inside = [(c, w) for t, c, w in samples if t0 <= t <= t1]
    if not inside:
        return None, None
    return (statistics.median(c for c, _ in inside),
            statistics.median(w for _, w in inside))


def run(reps, before, launch):
    """``reps`` iterations of ``before()`` then ``launch()``; returns the
    per-launch times of ``launch`` (ms) and the loop's time per iteration."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    before()
    launch()
    torch.cuda.synchronize()
    start.record()
    for a, b in ev:
        before()
        a.record()
        launch()
        b.record()
    end.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in ev], start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=600)
    ap.add_argument("--sleep-cycles", type=int, default=100000,
                    help="length of the device spin (about 50 us at 2 GHz)")
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bc6h_timing: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    topk, iters, shake = bc6h._budgets(1.0)
    budget = dict(topk=topk, iters=iters, shake=shake, mode_mask=0xFFFF)
    photo = np.exp(photo_rgba(args.side, args.side, seed=120)[..., :3] * 4.0)
    rows = {}
    for sg in (False, True):
        rgb = photo.copy()
        if sg:
            rgb[..., 1] *= -1.0
        a = np.ones(rgb.shape[:-1] + (1,), np.float32)
        arr = np.concatenate([rgb, a], -1).astype(np.float16)[None]
        img = gic.Image.from_array(arr, signed=sg, hdr=True)
        blocks = image_to_blocks(img.data)[:, :, :3].contiguous()
        h = bc6h.f32_to_half_int(blocks, sg).contiguous()
        h2 = torch.empty_like(h)
        hc = [h]

        def k6(t=None):
            return bc6h.bc6h_search(hc[0] if t is None else t, signed=sg,
                                    **budget)

        def convert():
            hc[0] = bc6h.f32_to_half_int(blocks, sg).contiguous()

        def clone():
            hc[0] = h.clone()

        flush = torch.empty(32 << 20, dtype=torch.int32, device=h.device)

        ctx = {
            "alone": (lambda: None, lambda: k6(h)),
            "after_copy": (lambda: h2.copy_(h), lambda: k6(h2)),
            "after_conversion": (convert, k6),
            "after_clone": (clone, k6),
            "conversion_then_fixed": (convert, lambda: k6(h)),
            "after_flush": (flush.zero_, lambda: k6(h)),
            "after_sleep": (lambda: torch.cuda._sleep(args.sleep_cycles),
                            lambda: k6(h)),
            "compress": (lambda: None,
                         lambda: gic.compress(gic.CompressType.DXBC6H, img)),
        }
        res = {}
        for name, (before, launch) in ctx.items():
            out = {}

            def loop(before=before, launch=launch, out=out):
                out["t"] = run(args.reps, before, launch)

            clock, watts = sampled(loop)
            per, loop_ms = out["t"]
            res[name] = {"launch_ms_median": statistics.median(per),
                         "launch_ms_mean": statistics.fmean(per),
                         "loop_ms_per_iter": loop_ms,
                         "sm_clock_mhz_median": clock,
                         "power_w_median": watts}
        rows["signed" if sg else "unsigned"] = res
    result = {"device": smi, "reps": args.reps,
              "sleep_cycles": args.sleep_cycles,
              "blocks": int(h.shape[0]), "contexts": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
