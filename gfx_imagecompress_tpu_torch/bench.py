"""Throughput bench of the port's block encoders on one NVIDIA GPU.

    python -m gfx_imagecompress_tpu_torch.bench [--out results.json]

The counterpart of the JAX package's ``bench.py``: BASELINE.json's five
configs as nine calls of the block encoders (BC1 64x256x256, BC4 and BC5
512x512, BC3 and BC2 1024x1024, BC6H 1024x1024 unsigned and signed, fast
BC7 1024x1024 at the fast RGB budget, full BC7 2048x2048 at quality 1.0 in
one call), on the same images drawn in the same order from one
``np.random.default_rng(0)``, under the same result keys. Prints ONE JSON
line, the headline (BC1 encode throughput per GPU in Mtexel/s; vs_baseline
is the ratio against the 1 Gtexel/s north-star target), and every result to
stderr; ``--out`` writes the results dict as JSON to a file, nothing else
does.

Each figure is the marginal device time of one call (``marginal_ms``).
Where the JAX bench differs from it:

- No input is perturbed and no output folded into a checksum: the JAX bench
  needs both to keep XLA from hoisting the encoder out of its on-device loop
  or dropping part of it, and eager PyTorch launches every call it is given.
- ``<key>_ops_util`` (operations per second over the card's float32 peak)
  takes the place of ``<key>_vpu_util``, which names a TPU unit; with
  ``<key>_hbm_frac`` (bytes per second over its HBM rate) it is given for
  every config, from the counts of ``roofline.py`` at the config's own
  budget and on its blocks.
- The results dict has none of the JAX bench's budget keys
  (``skipped_after``, ``bc6h_error``, ``bc7_full_error``): the JAX bench
  carries a time budget for its TPU compiles, and the card runs all nine
  configs in well under a minute. An encoder's exception propagates, so
  ``run`` raises and ``main`` exits non-zero.

Without a CUDA device ``main`` exits non-zero at once and computes nothing.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import roofline
from .kernels import bc1, bc4, bc6h, bc7_fast, bc7_full
from .pipeline.blocks import image_to_blocks

BASELINE_MTEXELS_PER_S = 1000.0

KEYS = ("bc1_256_mtexels_per_s", "bc4_512_mtexels_per_s",
        "bc5_512_mtexels_per_s", "bc3_1k_mtexels_per_s",
        "bc2_1k_mtexels_per_s", "bc6h_1k_ufloat_mtexels_per_s",
        "bc6h_1k_snorm_mtexels_per_s", "bc7_fast_1k_mtexels_per_s",
        "bc7_full_2k_mtexels_per_s")

# The options ``counts`` reads, per wrapper; it refuses any other, since the
# roofline counts of the others are those of the default budget.
COUNTED_OPTIONS = {"encode_bc6h_blocks": {"signed", "quality"},
                   "encode_bc7_fast_blocks": {"fast", "perceptual"}}

# A run's device sleep is this many times the host's time to issue its calls
# (read on an unslept run of as many calls), and at least SLEEP_MIN_MS.
SLEEP_OVER_ISSUE = 3.0
SLEEP_MIN_MS = 1.0
SLEEP_TRIES = 3
# cycles of ``torch.cuda._sleep`` timed once to convert ms into cycles
SLEEP_CALIBRATE_CYCLES = 10_000_000


def photo(rng, h, w, c=4):
    """The JAX bench's photo: smooth fields and noise of sigma 0.01 on every
    channel, alpha included, clipped to [0,1]; float32 (h,w,c)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([np.sin(x * 0.05) * 0.4 + 0.5,
                    np.cos(y * 0.04) * 0.4 + 0.5,
                    np.sin((x + y) * 0.03) * 0.3 + 0.5,
                    np.ones_like(x)], -1)[..., :c]
    img += rng.normal(0, 0.01, img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def configs(device):
    """The nine configs in the JAX bench's order, as ``(key, encode, kwargs,
    blocks, texels, n_lo, n_hi)``, their blocks on ``device``. The images are
    drawn as the configs are taken, in the JAX bench's order, the BC6H image
    between the 1K and the 2K ones."""
    rng = np.random.default_rng(0)

    def blocks_of(img):
        return image_to_blocks(torch.from_numpy(img).to(device))

    yield ("bc1_256_mtexels_per_s", bc1.encode_bc1_blocks, {},
           blocks_of(np.stack([photo(rng, 256, 256)] * 64)), 64 * 256 * 256,
           1, 5)
    g2 = blocks_of(photo(rng, 512, 512, 4)[None])
    # the slice is copied once: a wrapper takes a contiguous tensor on the card
    yield ("bc4_512_mtexels_per_s", bc4.encode_bc4_blocks, {},
           g2[:, :, 0].contiguous(), 512 * 512, 1, 5)
    yield ("bc5_512_mtexels_per_s", bc4.encode_bc5_blocks, {}, g2, 512 * 512,
           1, 5)
    b1k = blocks_of(photo(rng, 1024, 1024)[None])
    yield ("bc3_1k_mtexels_per_s", bc1.encode_bc3_blocks, {}, b1k,
           1024 * 1024, 1, 5)
    yield ("bc2_1k_mtexels_per_s", bc1.encode_bc2_blocks, {}, b1k,
           1024 * 1024, 1, 5)
    hdr = np.exp(photo(rng, 1024, 1024, 3).astype(np.float32) * 4.0)
    bh = blocks_of(hdr[None])
    for signed in (False, True):
        yield (f"bc6h_1k_{'snorm' if signed else 'ufloat'}_mtexels_per_s",
               bc6h.encode_bc6h_blocks, {"signed": signed}, bh, 1024 * 1024,
               1, 3)
    yield ("bc7_fast_1k_mtexels_per_s", bc7_fast.encode_bc7_fast_blocks,
           {"fast": True, "perceptual": False}, b1k, 1024 * 1024, 1, 3)
    yield ("bc7_full_2k_mtexels_per_s", bc7_full.encode_bc7_blocks, {},
           blocks_of(photo(rng, 2048, 2048)[None]), 2048 * 2048, 1, 3)


def counts(encode, kwargs, blocks):
    """(operations, bytes) per block of one of the nine configs' calls.
    Bytes: the input read once, the words and the float32 error written
    once. Operations: ``roofline.py``'s counts at the config's budget, on
    its blocks where the count reads the data (the BC4 hill climb, the share
    of opaque blocks, the share that the mode 6/7 bar leaves to full BC7's
    modes 6/7); fast and full BC7 add their shortlists' operations to the
    search's. Raises on an option that the counts do not read."""
    name = encode.__name__
    unread = set(kwargs) - COUNTED_OPTIONS.get(name, set())
    if unread:
        raise ValueError(f"bench.counts: {name}'s counts are those of its "
                         f"default budget; they do not read {sorted(unread)}")
    words = 2 if name in ("encode_bc1_blocks", "encode_bc4_blocks") else 4
    nbytes = blocks[0].numel() * blocks.element_size() + 4 * words + 4
    if name == "encode_bc6h_blocks":
        topk, iters, shake = bc6h._budgets(kwargs.get("quality", 1.0))
        ops = roofline.ops_bc6h(topk=topk, iters=iters, shake=shake)
    elif name == "encode_bc7_fast_blocks":
        plist, topk, uber = bc7_fast._budget(kwargs.get("fast", False), None,
                                             None, None)
        ops = roofline.ops_bc7_est(nparts=len(plist), k=topk)
        ops += roofline.ops_per_block(
            "bc7_fast", blocks, perceptual=kwargs.get("perceptual", True),
            uber=uber, k=topk)
    elif name == "encode_bc7_blocks":
        plan = bc7_full._plan(1.0, 0xFF, 1.0, None, None, None, None)
        bar = bc7_full._combined_alpha_bar(blocks, True, True)
        unbarred = 1.0 - bar.double().mean().item()
        ops = roofline.ops_bc7_full(unbarred)
        # one shortlist per configuration (modes 1/3 share one); mode 7's
        # skips the blocks the bar takes from modes 6/7
        seen = set()
        for mode, cfg in plan.shortlists.items():
            if not isinstance(cfg, dict):
                continue
            key = (tuple(sorted(cfg.items())), mode >= 6)
            if key in seen:
                continue
            seen.add(key)
            ops += roofline.ops_bc7_est(
                chans=cfg["chans"], subsets=cfg["subsets"],
                nparts=len(cfg["plist"]), k=cfg["k"],
                pca=cfg.get("estimator") == "pca") * (
                    unbarred if mode >= 6 else 1.0)
    else:                                   # encode_bc<n>_blocks, n in 1..5
        ops = roofline.ops_per_block(name.split("_")[1], blocks)
    return ops, nbytes


def marginal_ms(encode, blocks, n_lo=1, n_hi=5, reps=3):
    """Marginal device time in ms of one call of ``encode(blocks)``, and the
    largest share of a run's device sleep that the host took to issue the
    run's calls (below 1 on every run that counts).

    The counterpart of the JAX bench's ``_marginal_time``: one warm call;
    for each trip count n, ``reps`` runs of n calls, each run queued behind a
    device-side sleep (``torch.cuda._sleep``) and timed with CUDA events from
    the sleep's end to the last call's end; the best run of each count; the
    difference of the two over the difference of the counts. Below 1 ms it
    is measured again at 10 and 110 trips, as the JAX rule does.

    The sleep makes the events read the card, not the host: every wrapper
    launches on the current stream and never waits for the device, so the n
    calls run back to back as long as the host has issued them all before
    the sleep ends. The sleep is sized from the host: ``SLEEP_OVER_ISSUE``
    times its time to issue n calls on an unslept run, converted to cycles
    by a sleep timed once. Each run measures both again, the host's time to
    issue its calls (``time.perf_counter``) and the sleep's own device time
    (events around it). Where the issue time reaches the sleep's, the sleep
    is lengthened and the run made again; after ``SLEEP_TRIES`` tries it
    raises, so a figure that timed the host is never reported.

    No input is perturbed and no output reduced: eager PyTorch hoists no
    launch out of a loop, and the wrappers write every output. So each call
    reads the same input, which stays resident in the card's 50 MB L2 from
    call to call where it fits: the 1K RGBA input (16.8 MB) does, BC1's
    64x256x256 and full BC7's 2K inputs (67 MB each) do not."""
    encode(blocks)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CALIBRATE_CYCLES)
    ev[1].record()
    ev[1].synchronize()
    cycles_per_ms = SLEEP_CALIBRATE_CYCLES / ev[0].elapsed_time(ev[1])
    worst = 0.0

    def issue_ms(n):
        t0 = time.perf_counter()
        for _ in range(n):
            encode(blocks)
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return ms

    def run(n, sleep_ms):
        nonlocal worst
        for _ in range(SLEEP_TRIES):
            t0 = time.perf_counter()
            ev[0].record()
            torch.cuda._sleep(int(sleep_ms[0] * cycles_per_ms))
            ev[1].record()
            for _ in range(n):
                encode(blocks)
            ev[2].record()
            issued = (time.perf_counter() - t0) * 1e3
            ev[2].synchronize()
            slept = ev[0].elapsed_time(ev[1])
            if issued < slept:
                worst = max(worst, issued / slept)
                return ev[1].elapsed_time(ev[2])
            sleep_ms[0] = 2.0 * SLEEP_OVER_ISSUE * issued
        raise RuntimeError(
            f"marginal_ms: the host took {issued:.3f} ms to issue {n} calls, "
            f"the device sleep {slept:.3f} ms, after {SLEEP_TRIES} tries")

    def measure(lo, hi):
        best = {}
        for n in (lo, hi):
            sleep_ms = [max(SLEEP_MIN_MS, SLEEP_OVER_ISSUE * issue_ms(n))]
            best[n] = min(run(n, sleep_ms) for _ in range(reps))
        return (best[hi] - best[lo]) / (hi - lo)

    ms = measure(n_lo, n_hi)
    if ms < 1.0:
        ms = measure(10, 110)
    return max(ms, 1e-6), worst


def device_line(device):
    """The card's name and power limit as ``nvidia-smi`` gives them, the
    name CUDA gives the device, and torch's version."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = []
    return (f"{smi[0] if smi else 'nvidia-smi: no output'}; "
            f"{torch.cuda.get_device_name(device)}; torch {torch.__version__}"
            f", CUDA {torch.version.cuda}")


def run(device="cuda"):
    """Time the nine configs on ``device`` (a CUDA device) and return the
    results dict: ``device``, and per config ``<key>`` (Mtexel/s),
    ``<key>_ms`` (marginal ms per call), ``<key>_ops_util``,
    ``<key>_hbm_frac`` and ``<key>_issue_over_sleep`` (the largest share of
    a run's device sleep that the host took to issue its calls)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"bench.run: needs a CUDA device, got {device!r} "
                           f"(torch.cuda.is_available() is "
                           f"{torch.cuda.is_available()})")
    results = {"device": device_line(dev)}
    with torch.cuda.device(dev):
        for key, encode, kwargs, blocks, texels, n_lo, n_hi in configs(dev):
            ops, nbytes = counts(encode, kwargs, blocks)
            ms, guard = marginal_ms(functools.partial(encode, **kwargs),
                                    blocks, n_lo, n_hi)
            blocks_per_s = texels / 16.0 / (ms / 1e3)
            results[key] = texels / ms / 1e3
            results[key + "_ms"] = ms
            results[key + "_ops_util"] = (
                blocks_per_s * ops / roofline.PEAK_F32_OPS_PER_S)
            results[key + "_hbm_frac"] = (
                blocks_per_s * nbytes / roofline.PEAK_BYTES_PER_S)
            results[key + "_issue_over_sleep"] = guard
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="write the results dict as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is False); "
              "this bench does not run on the CPU", file=sys.stderr)
        return 1
    results = run()
    bc1_mts = results["bc1_256_mtexels_per_s"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps({
        "metric": "bc1_encode_throughput",
        "value": round(bc1_mts, 1),
        "unit": "Mtexels/s/gpu",
        "vs_baseline": round(bc1_mts / BASELINE_MTEXELS_PER_S, 4),
    }), flush=True)
    for k, v in results.items():
        print(f"  {k}: {v}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
