"""Quality benchmark: the port's PSNR against the reference algorithm's PSNR.

For each codec x quality level, encode the deterministic natural-image
corpus (``refcpu/corpus.py``) with

  (a) the port's shipping block encoders (``kernels/``): on a CUDA device
      they launch the hand-written kernels, on the CPU they run the plain
      versions, and
  (b) the reference-faithful CPU comparators (``refcpu/``),

decode both with the independent native C++ oracle (``native.py``) and
report RGB PSNR side by side (HDR PSNR for BC6H). The gate is port >=
reference on every row, less 0.05 dB of measurement noise.

The reference side is expensive (up to ~1.5 s a block for BC7 at the top
quality), so its PSNR is cached in ``refcpu/baseline_cache.json`` under a
hash of the row's name, corpus and options; the matrix, the hash and the
cache version are the JAX package's, so the cache answers the same rows.
``--refresh`` recomputes the reference side (in ``spawn`` worker
processes). Run:

    python -m gfx_imagecompress_tpu_torch.bench_quality [--device cpu]
        [--fast] [--refresh] [--only ROW ...] [--out results.json]

The results file is written only where ``--out`` names one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import sys
import time

import numpy as np
import torch

from .image import DeviceLike, resolve_device

_CACHE_PATH = os.path.join(os.path.dirname(__file__), "refcpu",
                           "baseline_cache.json")
_CACHE_VERSION = 2    # bump when any refcpu algorithm changes
TOL_DB = -0.05


def _blocks_from_images(imgs, channels=4):
    out = []
    for img in imgs:
        h, w = img.shape[:2]
        c = img.shape[2]
        if c < channels:
            pad = np.ones((h, w, channels - c), np.float32)
            img = np.concatenate([img, pad], -1)
        b = img[..., :channels].reshape(h // 4, 4, w // 4, 4, channels)
        out.append(b.transpose(0, 2, 1, 3, 4).reshape(-1, 16, channels))
    return np.concatenate(out)


def corpus_blocks(n=4, size=64, kind="opaque"):
    from .refcpu import corpus
    if kind == "hdr":
        return _blocks_from_images(corpus.corpus_hdr(n, size, size), 3)
    return _blocks_from_images(corpus.corpus_rgba(n, size, size, kind))


def _psnr_rgb_u8(dec, src255, channels=3):
    mse = ((dec[..., :channels].astype(np.float64)
            - src255[..., :channels]) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _psnr_half(dec_half_bits, src, peak):
    dec = dec_half_bits.astype(np.uint16).view(np.float16).astype(np.float64)
    mse = ((dec - src.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(peak ** 2 / max(mse, 1e-12))


# ---- reference-side encoders (run in worker processes) ------------------

def _ref_chunk(args):
    codec, opts, chunk = args
    from .refcpu import bc6h_amd, bc7_amd, bc7enc16, bcx_amd
    if codec == "bc1":
        return bcx_amd.encode_bc1_blocks(chunk, **opts)
    if codec == "bc2":
        return bcx_amd.encode_bc2_blocks(chunk, **opts)
    if codec == "bc3":
        return bcx_amd.encode_bc3_blocks(chunk, **opts)
    if codec == "bc4":
        return bcx_amd.encode_bc4_blocks(chunk[:, :, 0])
    if codec == "bc7_fast":
        return bc7enc16.encode_blocks(chunk, **opts)
    if codec == "bc7_full":
        return bc7_amd.encode_blocks(chunk, **opts)
    if codec == "bc6h":
        return bc6h_amd.encode_blocks(chunk[..., :3], **opts)
    raise ValueError(codec)


def ref_encode(codec, opts, blocks, procs=None):
    procs = procs or max(1, (os.cpu_count() or 1))
    chunks = np.array_split(blocks, procs * 4)
    args = [(codec, opts, c) for c in chunks if len(c)]
    if procs == 1:
        outs = [_ref_chunk(a) for a in args]
    else:
        # spawn, not fork: torch (and a CUDA context) may already be live in
        # this process, and fork copies them into the workers
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(procs) as pool:
            outs = pool.map(_ref_chunk, args)
    return np.concatenate(outs)


# ---- the port's side ------------------------------------------------------

def fw_encode(codec, opts, blocks, device: DeviceLike = None):
    """The port's encode of ``blocks`` (numpy, (N,16,C)) on ``device``
    (None: CUDA), through the wrappers ``api.py`` ships; -> (N,W) int32
    words on that device."""
    from .kernels import bc1, bc4, bc6h, bc7_fast, bc7_full
    from .options import PERCEPTUAL_WEIGHTS
    b = torch.from_numpy(np.ascontiguousarray(blocks, np.float32)).to(
        resolve_device(device))
    if codec == "bc1":
        kw = dict(opts)
        kw.setdefault("weights", PERCEPTUAL_WEIGHTS)
        w, _ = bc1.encode_bc1_blocks(b, **kw)
    elif codec == "bc4":
        w, _ = bc4.encode_bc4_blocks(b[:, :, 0].contiguous())
    elif codec == "bc2":
        w, _ = bc1.encode_bc2_blocks(b, **opts)
    elif codec == "bc3":
        w, _ = bc1.encode_bc3_blocks(b, **opts)
    elif codec == "bc7_fast":
        w, _ = bc7_fast.encode_bc7_fast_blocks(b, **opts)
    elif codec == "bc7_full":
        w, _ = bc7_full.encode_bc7_blocks(b, **opts)
    elif codec == "bc6h":
        w, _ = bc6h.encode_bc6h_blocks(b[..., :3].contiguous(), **opts)
    else:
        raise ValueError(codec)
    return w


# ---- configuration matrix ----------------------------------------------

def config_matrix(fast=False):
    """Rows: (name, codec, corpus_kind, ref_opts, fw_opts, decode)."""
    # heavy rows ride 4k blocks (16 images): 1k was within shot-noise of
    # corpus choice for a 0.03 dB delta
    n, size = (2, 32) if fast else (16, 64)
    nb, sb = (4, 64) if fast else (8, 128)      # big corpus for cheap codecs
    rows = [
        ("bc1", "bc1", (nb, sb, "opaque"), {}, {}, "bc1"),
        ("bc1_punch", "bc1", (nb, sb, "punch"),
         dict(use_alpha=True, alpha_threshold01=128 / 255.0),
         dict(use_alpha=True, alpha_threshold=128 / 255.0), "bc1"),
        ("bc4", "bc4", (nb, sb, "opaque"), {}, {}, "bc4"),
        ("bc2", "bc2", (nb, sb, "gradient"), {}, {}, "bc2"),
        ("bc3", "bc3", (nb, sb, "gradient"), {}, {}, "bc3"),
        ("bc7_fast", "bc7_fast", (nb, sb, "opaque"),
         dict(fast=False, perceptual=False),
         dict(fast=False, perceptual=False), "bc7"),
        ("bc7_fastest", "bc7_fast", (nb, sb, "opaque"),
         dict(fast=True, perceptual=False),
         dict(fast=True, perceptual=False), "bc7"),
        ("bc7_full_q1", "bc7_full", (n, size, "opaque"),
         dict(quality=1.0), dict(quality=1.0), "bc7"),
        ("bc7_full_q0.6", "bc7_full", (n, size, "opaque"),
         dict(quality=0.6), dict(quality=0.6), "bc7"),
        ("bc7_full_q0.3", "bc7_full", (n, size, "opaque"),
         dict(quality=0.3), dict(quality=0.3), "bc7"),
        ("bc7_full_alpha", "bc7_full", (n, size, "gradient"),
         dict(quality=1.0), dict(quality=1.0), "bc7"),
        # the performance<1 block-API regime: at perf=0.3 the reference's
        # quantizer gate (blockMaxRange > 255*perf, amd_bc7_body.cpp:606-630)
        # routes ~half of this small corpus through the TRACE quantizer
        # (refcpu _opt_quant_trace - exact optimal monotone clustering);
        # perf=0.5's threshold of 127.5 is above all but ~3% of corpus block
        # ranges and would measure nothing. Small corpus: the trace oracle is
        # ~15 s/block.
        ("bc7_full_p0.3", "bc7_full", (2, 32, "opaque"),
         dict(quality=0.3, performance=0.3),
         dict(quality=0.3, performance=0.3), "bc7"),
        ("bc6h_uf", "bc6h", (n, size, "hdr"),
         dict(signed=False), dict(signed=False), "bc6h_uf"),
        ("bc6h_sf", "bc6h", (n, size, "hdr"),
         dict(signed=True), dict(signed=True), "bc6h_sf"),
    ]
    return rows


def _decode_psnr(kind, words, blocks):
    from . import native
    if kind == "bc1":
        dec = native.decode_bc1(words)
        return _psnr_rgb_u8(dec, np.rint(blocks[..., :3] * 255.0))
    if kind == "bc4":
        dec = native.decode_bc4(words)
        return _psnr_rgb_u8(dec[..., None],
                            np.rint(blocks[..., :1] * 255.0), 1)
    if kind in ("bc2", "bc3"):
        dec = (native.decode_bc2 if kind == "bc2"
               else native.decode_bc3)(words)
        return _psnr_rgb_u8(dec, np.rint(blocks[..., :4] * 255.0), 4)
    if kind == "bc7":
        dec = native.decode_bc7(words)
        return _psnr_rgb_u8(dec, np.rint(blocks[..., :3] * 255.0))
    if kind in ("bc6h_uf", "bc6h_sf"):
        dech = native.decode_bc6h(words, signed=kind.endswith("sf"))
        peak = float(blocks[..., :3].max() - min(blocks[..., :3].min(), 0))
        return _psnr_half(dech, blocks[..., :3], peak)
    raise ValueError(kind)


def _cfg_key(name, corpus_cfg, opts):
    h = hashlib.sha256(json.dumps(
        [_CACHE_VERSION, name, list(corpus_cfg), sorted(opts.items())],
        default=str).encode()).hexdigest()[:16]
    return f"{name}:{h}"


def run(fast=False, refresh=False, only=None, procs=None, ref_only=False,
        device: DeviceLike = None, out=None, cached_only=False):
    """Run the matrix (or the rows named in ``only``) on ``device`` (None:
    CUDA); returns one dict per row. ``cached_only``: a reference PSNR
    missing from the cache raises (naming its key) instead of being
    computed. ``out``: a path to write the rows to as JSON."""
    dev = resolve_device(device)
    cache = {}
    if os.path.exists(_CACHE_PATH):
        with open(_CACHE_PATH) as f:
            cache = json.load(f)
    results = []
    dirty = False
    for name, codec, corpus_cfg, ref_opts, fw_opts, dec_kind in \
            config_matrix(fast):
        if only and name not in only:
            continue
        blocks = corpus_blocks(*corpus_cfg)
        key = _cfg_key(name, corpus_cfg, ref_opts)
        if key in cache and not refresh:
            ref_psnr = cache[key]
        elif cached_only:
            raise KeyError(f"bench_quality: reference PSNR of row {name!r} "
                           f"is not in the cache (key {key})")
        else:
            w_ref = ref_encode(codec, ref_opts, blocks, procs)
            ref_psnr = float(_decode_psnr(dec_kind, w_ref, blocks))
            cache[key] = ref_psnr
            dirty = True
        if ref_only:
            print(f"{name:16s} ref {ref_psnr:7.3f}  (ref-only)",
                  file=sys.stderr)
            continue
        t0 = time.perf_counter()
        w_fw = fw_encode(codec, fw_opts, blocks, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        fw_s = time.perf_counter() - t0
        fw_psnr = float(_decode_psnr(dec_kind, w_fw, blocks))
        delta = fw_psnr - ref_psnr
        results.append(dict(config=name, blocks=int(len(blocks)),
                            path=dev.type, key=key,
                            ref_psnr=round(ref_psnr, 3),
                            fw_psnr=round(fw_psnr, 3),
                            delta_db=round(delta, 3),
                            ok=bool(delta >= TOL_DB), fw_seconds=fw_s))
        print(f"{name:16s} ref {ref_psnr:7.3f}  fw {fw_psnr:7.3f}  "
              f"delta {delta:+.3f} dB  "
              f"{'OK' if delta >= TOL_DB else 'BEHIND'}", file=sys.stderr)
    if dirty:
        with open(_CACHE_PATH, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
    if out and not ref_only:
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--refresh", action="store_true")
    ap.add_argument("--only", nargs="*")
    ap.add_argument("--procs", type=int)
    ap.add_argument("--ref-only", action="store_true",
                    help="only (re)compute and cache the reference side")
    ap.add_argument("--out", default=None,
                    help="write the rows to this JSON file")
    a = ap.parse_args()
    results = run(fast=a.fast, refresh=a.refresh, only=a.only, procs=a.procs,
                  ref_only=a.ref_only, device=a.device, out=a.out)
    worst = min((r["delta_db"] for r in results), default=0.0)
    print(json.dumps({"metric": "quality_vs_reference_worst_delta",
                      "value": round(worst, 3), "unit": "dB",
                      "vs_baseline": round(worst, 3)}))


if __name__ == "__main__":
    main()
