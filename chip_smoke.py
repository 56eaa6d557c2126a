#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # full run, needs one CUDA device
    python3 chip_smoke.py --quick    # toy sizes: build + correctness only;
                                     # prints no final result lines
    python3 chip_smoke.py --out DIR  # also write results and ptxas logs there

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card, drives ``compress()`` for
BC1-BC5, for the fast BC7 path, for the full BC7 path and for BC6H (unsigned
and signed) at the sizes BASELINE.json names, decodes and checks every result,
and shows with the launch counters that each path went through its kernels.
Then it drives the batched block entries (``blockapi``), holds the port's
decoders against the native C++ oracle on every block it emitted, runs the
quality matrix against the cached reference encoders (``bench_quality``),
and encodes sharded in an NCCL process group of one (``dist.sharded``).
Last, it runs the throughput bench (``bench.run()``) twice and holds each of
its configs to the plain versions on the card.
Each phase prints one JSON line. Any failed check makes the exit code non-zero
and suppresses the final ``{"ok": true, ...}`` line. Without a CUDA device
the script exits non-zero at once; it never computes on the CPU.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

PERCEPTUAL = (0.3086, 0.6094, 0.0820)
FAILURES: list[str] = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> bool:
    if not ok:
        FAILURES.append(what)
        print(f"CHECK FAILED: {what}", file=sys.stderr, flush=True)
    return bool(ok)


# ------------------------------------------------------------------ data ---

def photo_rgba(h, w, seed=0, noise=0.015):
    """Photo-like content: smooth multi-frequency fields + mild noise, opaque
    alpha (the fixture the repo's quality thresholds are written for)."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([
        np.sin(x * 0.21 + y * 0.07) * 0.4 + 0.5,
        np.sin(x * 0.05 + 1.0) * np.cos(y * 0.11) * 0.35 + 0.5,
        np.sin((x + y) * 0.13 + 2.0) * 0.3 + 0.45,
        np.ones_like(x)], axis=-1)
    img[..., :3] += r.normal(0, noise, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def with_alpha_field(img, seed):
    """Give a photo a real alpha channel: a smooth field with mild noise."""
    r = np.random.default_rng(seed)
    h, w = img.shape[:2]
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    a = np.sin(x * 0.09 + 0.5) * np.cos(y * 0.06) * 0.45 + 0.5
    a += r.normal(0, 0.01, (h, w)).astype(np.float32)
    out = img.copy()
    out[..., 3] = np.clip(a, 0.0, 1.0)
    return out


def to_blocks_np(img):
    h, w, c = img.shape
    t = img.reshape(h // 4, 4, w // 4, 4, c).transpose(0, 2, 1, 3, 4)
    return t.reshape(-1, 16, c)


def mixed_blocks(n_total, seed=7):
    """(N,16,4) float32 blocks: photo-like content with a real alpha channel,
    uniform noise, and the hard cases of a BCn search."""
    r = np.random.default_rng(seed)
    hard_each = 256
    parts = []
    # solid blocks
    parts.append(np.repeat(r.random((hard_each, 1, 4), np.float32), 16, 1))
    # two-colour blocks
    c = r.random((hard_each, 2, 4), np.float32)
    pick = r.integers(0, 2, (hard_each, 16))
    parts.append(np.take_along_axis(c, pick[:, :, None].repeat(4, 2), 1))
    # one-level gradient: two adjacent 8-bit levels
    base = r.integers(0, 255, (hard_each, 1, 4))
    step = r.integers(0, 2, (hard_each, 16, 1))
    parts.append(((base + step) / 255.0).astype(np.float32))
    # all-transparent and half-transparent blocks
    t = r.random((hard_each, 16, 4), np.float32)
    t[..., 3] = 0.0
    parts.append(t)
    t = r.random((hard_each, 16, 4), np.float32)
    t[..., 3] = r.integers(0, 2, (hard_each, 16)).astype(np.float32)
    parts.append(t)
    # alpha exactly at the threshold 128/255, and just below it
    t = np.repeat(r.random((hard_each, 1, 4), np.float32), 16, 1)
    t += r.normal(0, 0.03, t.shape).astype(np.float32)
    t = np.clip(t, 0, 1)
    t[..., 3] = np.where(r.integers(0, 2, (hard_each, 16)) > 0,
                         np.float32(128 / 255.0), np.float32(127 / 255.0))
    parts.append(t)
    # values exactly 0 and 1; all-zero and all-one blocks
    parts.append(r.integers(0, 2, (hard_each, 16, 4)).astype(np.float32))
    parts.append(np.zeros((8, 16, 4), np.float32))
    parts.append(np.ones((8, 16, 4), np.float32))
    # opaque two-colour blocks split along BC7's 2-subset shapes 0 and 13
    # (bit p of the shape = subset of pixel p), with mild noise
    for shape in (0xCCCC, 0xFF00):
        c = r.random((hard_each, 2, 4), np.float32)
        pick = np.array([(shape >> p) & 1 for p in range(16)])
        t = c[:, pick, :] + r.normal(0, 0.01, (hard_each, 16, 4)).astype(
            np.float32)
        t = np.clip(t, 0, 1)
        t[..., 3] = 1.0
        parts.append(t)
    # opaque solid colours, and a smooth partial alpha over a colour gradient
    t = np.repeat(r.random((hard_each, 1, 4), np.float32), 16, 1)
    t[..., 3] = 1.0
    parts.append(t)
    t = np.linspace(0, 1, 16, dtype=np.float32)[None, :, None] * r.random(
        (hard_each, 1, 4), np.float32) + r.random((hard_each, 1, 4),
                                                  np.float32) * 0.5
    parts.append(np.clip(t, 0, 1))
    n_hard = sum(p.shape[0] for p in parts)
    n_noise = (n_total - n_hard) // 4
    parts.append(r.random((n_noise, 16, 4), np.float32))
    n_photo = n_total - n_hard - n_noise
    side = 4 * int(np.ceil(np.sqrt(n_photo)))
    photo = with_alpha_field(photo_rgba(side, side, seed=seed), seed + 1)
    # punch some of the photo's alpha well below the threshold
    photo[::5, ::3, 3] *= 0.3
    parts.append(to_blocks_np(photo)[:n_photo])
    out = np.concatenate(parts, 0).astype(np.float32)
    assert out.shape[0] == n_total
    return np.ascontiguousarray(out)


def hdr_field(h, w, seed=0, signed=False):
    """Environment-map-like HDR field (the JAX package's test fixture):
    smooth exponent variation with multiplicative noise; signed negates
    green."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([np.exp(np.sin(x * 0.09) * 2.0),
                    np.exp(np.cos(y * 0.07) * 1.5) * 0.3,
                    (np.sin((x + y) * 0.05) * 0.5 + 0.6) * 10.0], axis=-1)
    img *= (1.0 + r.normal(0, 0.01, img.shape)).astype(np.float32)
    if signed:
        img[..., 1] *= -1.0
    return img.astype(np.float32)


def mixed_hdr_blocks(n_total, seed=9, signed=False):
    """(N,16,3) float32 HDR blocks: environment-map blocks with
    multiplicative noise, and the hard cases of a BC6H search - solid blocks
    and zeros, values at and above 65504 and +inf, negatives (the unsigned
    path clamps them to 0), values in the half subnormal range, two-level
    contrast, and magnitudes spread over the whole half range."""
    r = np.random.default_rng(seed)
    hard = 512
    parts = [np.repeat(r.random((hard, 1, 3)) * 100.0, 16, 1),
             np.zeros((16, 16, 3)),
             r.choice([65504.0, 65519.0, 65520.0, 70000.0, np.inf, 1000.0],
                      (hard, 16, 3)),
             r.normal(0, 5.0, (hard, 16, 3)),
             r.random((hard, 16, 3)) * 6e-5,
             np.where(r.random((hard, 16, 3)) < 0.5, 60000.0, 1e-4),
             np.exp(r.uniform(-14, 11, (hard, 16, 3)))
             * np.where(r.random((hard, 16, 3)) < 0.3, -1.0, 1.0)]
    n_env = n_total - sum(p.shape[0] for p in parts)
    side = 4 * int(np.ceil(np.sqrt(n_env)))
    env = to_blocks_np(hdr_field(side, side, seed=seed, signed=signed))
    parts.append(env[:n_env])
    out = np.concatenate(parts, 0).astype(np.float32)
    assert out.shape[0] == n_total
    return np.ascontiguousarray(out)


# ------------------------------------------------------------- measuring ---

def time_ms(fn, reps):
    """Mean time of ``fn`` in ms over ``reps`` calls, CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps):
    """Mean time of ``fn`` in ms over ``reps`` calls, CUDA events, the calls
    queued behind a device-side sleep of about 20 ms so that they run back
    to back on the card: for launches shorter than the host takes to issue
    them. One warm-up call first."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(before, launch, reps):
    """Mean time in ms of ``launch()`` alone, CUDA events around it, over
    ``reps`` iterations of ``before()`` then ``launch()``, after one
    warm-up iteration."""
    before()
    launch()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        before()
        a.record()
        launch()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / reps


def psnr(a, b):
    mse = torch.mean((a.double() - b.double()) ** 2).item()
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


# ------------------------------------------------------ kernel vs plain ---

def adaptive_weights(blocks):
    """Per-block colour weights of the adaptive path, (N,3) float32."""
    mc = (blocks[..., :3] * 255.0).sum(1) / 16.0
    largest = torch.maximum(torch.maximum(mc[:, 0], mc[:, 1]),
                            mc[:, 2].clamp(min=1e-6))
    w = torch.tensor(PERCEPTUAL, device=blocks.device) * (
        3.0 * mc / largest[:, None] + 1.0) * 0.25
    return w / w.sum(1, keepdim=True)


def bc7_metric():
    """The fast BC7 encoder's perceptual metric: (3x3 map, 4 weights)."""
    from gfx_imagecompress_tpu_torch.kernels import bc7_fast
    return bc7_fast._YCBCR_M.tolist(), list(bc7_fast.PERCEP_W)


def decoded_error(name, blocks, words, kw, decode):
    """The error of the emitted words, measured with the port's decoder, in
    the units the encoder reports (float64 on the card)."""
    if name == "bc6h":
        # in half-int space; signed: the signed decoded integers
        from gfx_imagecompress_tpu_torch.decode.bc6h import decode_bc6h_half
        from gfx_imagecompress_tpu_torch.kernels.bc6h import f32_to_half_int
        signed = kw.get("signed", False)
        hd = decode_bc6h_half(words, signed).long()
        if signed:
            hd = torch.where(hd >= 0x8000, -(hd & 0x7FFF), hd)
        tgt = f32_to_half_int(blocks, signed).long()
        return ((tgt - hd).double() ** 2).sum((1, 2))
    src = blocks.double() * 255.0
    if name == "bc7_full":
        from gfx_imagecompress_tpu_torch.decode.bc7 import decode_bc7
        return ((src - decode_bc7(words).double()) ** 2).sum((1, 2))
    if name == "bc7_fast":
        from gfx_imagecompress_tpu_torch.decode.bc7 import decode_bc7
        dec = decode_bc7(words).double()
        if kw.get("perceptual", True):
            # the encoder's metric: YCbCr map and channel weights
            m = torch.tensor(bc7_metric()[0], device=blocks.device).double()
            w = torch.tensor(bc7_metric()[1], device=blocks.device).double()
            src = torch.cat([src[..., :3] @ m.T, src[..., 3:]], -1)
            dec = torch.cat([dec[..., :3] @ m.T, dec[..., 3:]], -1)
            return ((src - dec) ** 2 * w).sum((1, 2))
        return ((src - dec) ** 2).sum((1, 2))
    if name == "bc4":
        return ((src - decode.decode_bc4_block(words).double()) ** 2).sum(1)
    if name == "bc5":
        dec = decode.decode_bc5(words).double()
        return ((src[..., :2] - dec) ** 2).sum((1, 2))
    if name == "bc1":
        dec = decode.decode_bc1(
            words, force_four=not kw.get("allow_three", True)).double()
    elif name == "bc2":
        dec = decode.decode_bc2(words).double()
    else:
        dec = decode.decode_bc3(words).double()
    if kw.get("adaptive"):
        w = adaptive_weights(blocks).double()[:, None, :]
    else:
        w = torch.tensor(PERCEPTUAL, device=blocks.device).double()
    d = ((src[..., :3] - dec[..., :3]) ** 2 * w).sum(2)
    if name == "bc1" and kw.get("use_alpha"):
        thr = np.float32(float(kw["alpha_threshold"]) * 255.0)
        d = d * ((blocks[..., 3] * 255.0) >= float(thr)).double()
    err = d.sum(1)
    if name == "bc3":
        err = err + ((src[..., 3] - dec[..., 3]) ** 2).sum(1)
    if name == "bc2":       # BC2 reports its alpha error from the 8-bit alpha
        a8 = torch.round(blocks[..., 3] * 255.0).clamp(0, 255).double()
        err = err + ((a8 - dec[..., 3]) ** 2).sum(1)
    return err


def compare(name, label, wrapper, plain, x, kw, decode, reps, exact_cols=(),
            extra=None):
    """Run kernel and plain version on the same CUDA tensor; check (a) the
    reported error against the decoder, (b) summed error both ways, (c) the
    fraction of identical blocks. Returns a result dict with timings; the
    kernel is timed before the plain version runs, as the main path has it."""
    wk, ek = wrapper(x, **kw)
    kernel_ms = time_ms(lambda: wrapper(x, **kw), reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wp, ep = plain(x, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = (wk == wp).all(1)
    frac = same.double().mean().item()
    max_abs = (ek - ep).abs().max().item()
    sk, sp = ek.double().sum().item(), ep.double().sum().item()
    dec_err = decoded_error(name, x, wk, kw, decode)
    tol_ok = ((dec_err - ek.double()).abs()
              <= 0.5 + 1e-4 * dec_err.abs()).all().item()
    tag = f"{name}[{label}]"
    check(torch.isfinite(ek).all().item(), f"{tag}: non-finite error")
    check(tol_ok, f"{tag}: reported error != decoded error "
          "(rtol 1e-4, atol 0.5)")
    check(sk <= sp * 1.0001 + 1e-3 and sp <= sk * 1.0001 + 1e-3,
          f"{tag}: summed error kernel {sk} vs plain {sp} beyond x1.0001")
    check(frac >= 0.99, f"{tag}: only {frac:.5f} of blocks identical")
    for lo, hi, what in exact_cols:
        check((wk[:, lo:hi] == wp[:, lo:hi]).all().item(),
              f"{tag}: {what} words not bit-identical")
    if name in ("bc4", "bc5", "bc6h"):
        check(max_abs == 0.0, f"{tag}: errors differ from the plain version "
              f"by up to {max_abs}")
    row = {"kernel": name, "budget": label, "n_blocks": int(x.shape[0]),
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "identical_frac": frac, "max_abs_err": max_abs,
           "reported_equals_decoded": bool(tol_ok),
           "sum_err_kernel": sk, "sum_err_plain": sp}
    if extra is not None:
        row.update(extra(tag, x, wk, kw) or {})
    return row


def alpha_blocks_take_mode6(tag, x, words, kw):
    """A BC7 block whose alpha is not all 255 must carry mode 6."""
    from gfx_imagecompress_tpu_torch.decode.bc7 import block_modes
    has_alpha = (x[..., 3] * 255.0).amin(1) < 254.999
    check((block_modes(words)[has_alpha] == 6).all().item(),
          f"{tag}: a block with alpha does not carry mode 6")


def barred_blocks_avoid_modes_6_7(tag, x, words, kw):
    """Full BC7: a block the restrictions bar from modes 6/7 carries neither
    (where a mode 0-5 is enabled); returns the count of blocks per mode."""
    from gfx_imagecompress_tpu_torch.decode.bc7 import block_modes
    from gfx_imagecompress_tpu_torch.kernels import bc7_full
    modes = block_modes(words)
    mask = kw.get("mode_mask", 0xFF)
    if mask & 0x3F:
        bar = bc7_full._combined_alpha_bar(
            x, kw.get("colour_restrict", True), kw.get("alpha_restrict", True))
        check(not ((modes[bar] == 6) | (modes[bar] == 7)).any().item(),
              f"{tag}: a barred block carries mode 6 or 7")
    check(all((mask >> m) & 1 for m in modes.unique().tolist()),
          f"{tag}: a block carries a mode the mask does not enable")
    return {"blocks_per_mode": torch.bincount(
        modes.long(), minlength=9)[:8].tolist()}


def bc6h_modes_enabled(tag, x, words, kw):
    """BC6H: every block carries a mode the mask enables; returns the count
    of blocks per mode (1..14)."""
    from gfx_imagecompress_tpu_torch.tables.bc6h_tables import BC6H_MODES
    w0 = words[:, 0].long() & 0x1F
    code = torch.where((w0 & 3) < 2, w0 & 3, w0)
    mask = kw.get("mode_mask", 0xFFFF)
    per_mode = [int((code == m.code).sum().item()) for m in BC6H_MODES]
    check(sum(n for mi, n in enumerate(per_mode) if (mask >> mi) & 1)
          == words.shape[0], f"{tag}: a block carries a mode the mask "
          "does not enable")
    return {"blocks_per_mode": per_mode}


def compare_est(label, est, x, cfg, reps):
    """The shortlist kernel against its plain version: equal ids on every
    block."""
    ik = est.estimate_topk(x, **cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ip = est.estimate_topk_plain(x, **cfg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms = time_ms(lambda: est.estimate_topk(x, **cfg), reps)
    same = (ik == ip).all(1)
    check(same.all().item(), f"bc7_est[{label}]: ids differ from the plain "
          f"version on {int((~same).sum())} of {x.shape[0]} blocks")
    return {"kernel": "bc7_est", "budget": label, "n_blocks": int(x.shape[0]),
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "identical_frac": same.double().mean().item(),
            "max_abs_err": float((ik - ip).abs().max().item())}


# ------------------------------------------------ the later slices' phases ---

def _decoders():
    """Format -> (the port's decoder on the card, the native oracle), both to
    numpy arrays of one dtype."""
    from gfx_imagecompress_tpu_torch import native
    from gfx_imagecompress_tpu_torch.decode import bcn
    from gfx_imagecompress_tpu_torch.decode.bc6h import decode_bc6h_half
    from gfx_imagecompress_tpu_torch.decode.bc7 import decode_bc7

    def np8(t):
        return t.cpu().numpy().astype(np.uint8)

    return {
        "bc1": (lambda w: np8(bcn.decode_bc1(w)), native.decode_bc1),
        "bc1_four": (lambda w: np8(bcn.decode_bc1(w, force_four=True)),
                     lambda w: native.decode_bc1(w, force_four=True)),
        "bc2": (lambda w: np8(bcn.decode_bc2(w)), native.decode_bc2),
        "bc3": (lambda w: np8(bcn.decode_bc3(w)), native.decode_bc3),
        "bc4": (lambda w: np8(bcn.decode_bc4(w)[:, :, 0]), native.decode_bc4),
        "bc5": (lambda w: np8(bcn.decode_bc5(w)), native.decode_bc5),
        "bc7": (lambda w: np8(decode_bc7(w)), native.decode_bc7),
        "bc6h_uf": (lambda w: decode_bc6h_half(w, False).cpu().numpy()
                    .astype(np.uint16),
                    lambda w: native.decode_bc6h(w, signed=False)),
        "bc6h_sf": (lambda w: decode_bc6h_half(w, True).cpu().numpy()
                    .astype(np.uint16),
                    lambda w: native.decode_bc6h(w, signed=True)),
    }


def _packed_rgba8(blocks01):
    """(N,16,4) floats in [0,1] -> (N,16) int32 storage of packed RGBA8
    words (R in the low byte), as a caller of the bc7enc16 entry holds
    them."""
    q = torch.round(blocks01 * 255.0).to(torch.int64)
    p = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
    return torch.where(p >= 2 ** 31, p - 2 ** 32, p).to(torch.int32)


def phase_block_api(smi, rgba, alpha, quick):
    """The six batched block entries (``blockapi``) on the card, on the 1K
    photo's blocks (the alpha entries on the 1K alpha field): one run with
    the launch counts set to 0 before it and read after it, then for each
    entry its time, a decode through the native oracle, and its words
    against the same entry's plain versions run on the card on a slice
    (1,024 blocks for the BC7 entries, every block for the others; the
    explicit alpha entry bit-exact against the same entry on the CPU)."""
    from gfx_imagecompress_tpu_torch import blockapi, kernels, native
    from gfx_imagecompress_tpu_torch.kernels import bc1, bc4, bc7_fast
    from gfx_imagecompress_tpu_torch.kernels import bc7_full
    t0 = time.perf_counter()
    n = rgba.shape[0]
    thr = 128 / 255.0
    punch = rgba.clone()
    punch[..., 3] = alpha
    packed = _packed_rgba8(rgba)
    unpacked = torch.stack([(packed.to(torch.int64) >> s) & 0xFF
                            for s in (0, 8, 16, 24)], -1).to(torch.float32)
    unpacked = torch.div(unpacked, torch.full_like(unpacked, 255.0))
    rgb = rgba[..., :3]
    w3 = PERCEPTUAL                     # the block entries' colour weights
    # name -> (entry call, plain call on a slice, slice size, decode key or
    #          None, source in 0..255 and its channels for the PSNR)
    small = 256 if quick else 1024
    n_b3d = 256 if quick else 4096
    entries = {
        "rgb_single_mode": (
            lambda x=rgb: blockapi.compress_rgb_single_mode_blocks(x),
            lambda k: bc1.encode_bc1_blocks_plain(
                rgb[:k], w3, 3, 1, allow_three=False)[0], n, "bc1_four",
            rgba, 3),
        "rgb_single_mode_b3d_r0": (
            lambda x=rgb[:n_b3d]: blockapi.compress_rgb_single_mode_blocks(
                x, b3d_refinement=True, refinement_steps=0),
            lambda k: bc1.encode_bc1_blocks_plain(
                rgb[:k], w3, 2, 1, allow_three=False, b3d=True)[0], n_b3d,
            "bc1_four", rgba[:n_b3d], 3),
        "bc1": (lambda x=rgba: blockapi.compress_bc1_blocks(x),
                lambda k: bc1.encode_bc1_blocks_plain(rgba[:k], w3, 3, 1)[0],
                n, "bc1", rgba, 3),
        "bc1_punch": (
            lambda x=punch: blockapi.compress_bc1_blocks(
                x, alpha_threshold=thr),
            lambda k: bc1.encode_bc1_blocks_plain(
                punch[:k], w3, 3, 1, use_alpha=True,
                alpha_threshold=thr)[0], n, "bc1", None, 3),
        "alpha_single_mode": (
            lambda x=alpha: blockapi.compress_alpha_single_mode_blocks(x),
            lambda k: bc4.encode_bc4_blocks_plain(alpha[:k])[0], n, "bc4",
            alpha[..., None], 1),
        "explicit_alpha": (
            lambda x=alpha: blockapi.compress_explicit_alpha_blocks(x),
            lambda k: blockapi.compress_explicit_alpha_blocks(
                alpha[:k].cpu(), device="cpu"), n, "bc2", None, 1),
        "multi_mode_ldr": (
            lambda x=rgba: blockapi.compress_multi_mode_ldr_blocks(x),
            lambda k: bc7_full.encode_bc7_blocks_plain(rgba[:k])[0], small,
            "bc7", rgba, 3),
        "bc7enc16": (
            lambda x=packed: blockapi.compress_richgel999_bc7enc16_blocks(x),
            lambda k: bc7_fast.encode_bc7_fast_blocks_plain(
                unpacked[:k])[0], small, "bc7", unpacked, 4),
    }
    kernels.reset_launch_counts()
    words = {name: e[0]() for name, e in entries.items()}
    torch.cuda.synchronize()
    got = kernels.launch_counts()
    launches = {k: got[k] for k in ("bc1", "bc4", "bc7_est", "bc7_full",
                                    "bc7_fast")}
    for k, v in launches.items():
        check(v > 0, f"block_api: the entries never launched the {k} kernel")
    rows = []
    for name, (call, plain, k, dec_key, src, nch) in entries.items():
        w = words[name]
        nb = w.shape[0]
        check(w.dtype == torch.int32 and w.device.type == "cuda"
              and tuple(w.shape) == (nb, 4 if dec_key == "bc7" else 2),
              f"block_api[{name}]: words {w.dtype} {tuple(w.shape)} on "
              f"{w.device}")
        k = min(k, nb)
        pw = plain(k)
        same = (w[:k].cpu() == pw.cpu()).all(dim=1).double().mean().item()
        check(same == 1.0, f"block_api[{name}]: {same:.6f} of the first {k} "
              "blocks equal the plain versions")
        if dec_key == "bc2":
            dec = native.decode_bc2(torch.cat([w, torch.zeros_like(w)], 1))
            dec = dec[..., 3:4]
            ref = torch.round(alpha[..., None] * 255.0)
        else:
            dec = native.decode_bc1(w, force_four=True) if (
                dec_key == "bc1_four") else getattr(
                native, f"decode_{dec_key}")(w)
            if dec.ndim == 2:
                dec = dec[..., None]
            if src is None:                 # punch-through: opaque pixels
                dec_t = torch.from_numpy(dec.astype(np.int64))
                opq = (punch[..., 3] * 255.0 >= thr * 255.0).cpu()
                check(((dec_t[..., 3] > 127) == opq).all().item(),
                      f"block_api[{name}]: decoded alpha differs from the "
                      "mask")
                dec = dec[..., :3][opq.numpy()]
                ref = torch.round(punch[..., :3] * 255.0).cpu()[opq]
            else:
                ref = torch.round(src[..., :nch] * 255.0)
            dec = dec[..., :nch]
        db = psnr(torch.from_numpy(np.ascontiguousarray(dec)).to(torch.int64),
                  ref.cpu())
        floor = 20.0 if name == "explicit_alpha" else 30.0
        check(np.isfinite(db) and db > floor,
              f"block_api[{name}]: PSNR {db:.2f} dB <= {floor}")
        ms = time_ms(call, 1 if quick else 10)
        rows.append({"entry": name, "blocks": nb, "ms": ms,
                     "mtexel_per_s": nb * 16 / ms / 1e3, "psnr_db": db,
                     "plain_blocks_compared": k,
                     "identical_frac_vs_plain": same})
    ex = words["explicit_alpha"]
    cpu = blockapi.compress_explicit_alpha_blocks(alpha.cpu(), device="cpu")
    check(torch.equal(ex.cpu(), cpu), "block_api[explicit_alpha]: the card "
          "differs from the CPU")
    return {"phase": "block_api", "device": smi, "quick": quick,
            "launches": launches, "entries": rows,
            "seconds": time.perf_counter() - t0}, words


def phase_native_oracle(native_info, emitted):
    """The port's decoders (on the card) against the native oracle on every
    block the main path and the block entries emitted."""
    t0 = time.perf_counter()
    dec = _decoders()
    per_format = {}
    for label, key, words in emitted:
        port_fn, oracle_fn = dec[key]
        w = words.reshape(-1, words.shape[-1]).contiguous()
        a = port_fn(w)
        b = oracle_fn(w)
        same = a.shape == b.shape and bool((a == b).all())
        check(same, f"native_oracle[{label}]: the port's {key} decoder "
              "differs from the native oracle")
        f = per_format.setdefault(key, {"blocks": 0, "outputs": 0,
                                        "equal": True})
        f["blocks"] += int(w.shape[0])
        f["outputs"] += 1
        f["equal"] = f["equal"] and same
    for key in ("bc1", "bc2", "bc3", "bc4", "bc5", "bc7", "bc6h_uf",
                "bc6h_sf"):
        check(key in per_format, f"native_oracle: no {key} block checked")
    return {"phase": "native_oracle", "build_seconds": native_info["seconds"],
            "built": native_info["built"], "formats": per_format,
            "seconds": time.perf_counter() - t0}


def _plain_encode(codec, opts, b):
    """The plain version of what ``bench_quality.fw_encode`` calls, on the
    same device."""
    from gfx_imagecompress_tpu_torch.kernels import (bc1, bc4, bc6h, bc7_fast,
                                                     bc7_full)
    if codec == "bc1":
        return bc1.encode_bc1_blocks_plain(b, **opts)[0]
    if codec == "bc4":
        return bc4.encode_bc4_blocks_plain(b[:, :, 0])[0]
    if codec == "bc2":
        return bc1.encode_bc2_blocks_plain(b, **opts)[0]
    if codec == "bc3":
        return bc1.encode_bc3_blocks_plain(b, **opts)[0]
    if codec == "bc7_fast":
        return bc7_fast.encode_bc7_fast_blocks_plain(b, **opts)[0]
    if codec == "bc7_full":
        return bc7_full.encode_bc7_blocks_plain(b, **opts)[0]
    return bc6h.encode_bc6h_blocks_plain(b[..., :3], **opts)[0]


def phase_quality_matrix(smi, quick):
    """``bench_quality.run(device="cuda")`` over the full matrix (the cheap
    rows in a quick run), the reference side only from the cache: a miss is
    a failed check. The gate is the JAX package's own, delta >= -0.05 dB on
    every row. Each row's words are also held against the plain versions
    run on the card."""
    from gfx_imagecompress_tpu_torch import bench_quality as bq
    from gfx_imagecompress_tpu_torch import kernels
    t0 = time.perf_counter()
    only = ["bc1", "bc4"] if quick else None
    kernels.reset_launch_counts()
    try:
        rows = bq.run(device="cuda", only=only, cached_only=True)
    except KeyError as e:
        check(False, f"quality_matrix: {e}")
        return {"phase": "quality_matrix", "rows": [],
                "seconds": time.perf_counter() - t0}
    got = kernels.launch_counts()
    launches = {k: got[k] for k in got if k != "bc5"}
    for k in (("bc1", "bc4") if quick else launches):
        check(launches[k] > 0, f"quality_matrix: never launched {k}")
    check(len(rows) == (2 if quick else 14),
          f"quality_matrix: {len(rows)} rows")
    matrix = {r[0]: r for r in bq.config_matrix()}
    out = []
    for r in rows:
        _, codec, corpus_cfg, _, fw_opts, dec_kind = matrix[r["config"]]
        check(r["delta_db"] >= bq.TOL_DB,
              f"quality_matrix[{r['config']}]: port {r['fw_psnr']} dB vs "
              f"reference {r['ref_psnr']} dB (delta {r['delta_db']} dB)")
        blocks = bq.corpus_blocks(*corpus_cfg)
        b = torch.from_numpy(np.ascontiguousarray(blocks, np.float32)).cuda()
        kw = dict(fw_opts)
        if codec == "bc1":
            kw.setdefault("weights", PERCEPTUAL)
        kernel_words = bq.fw_encode(codec, fw_opts, blocks, "cuda")
        plain_words = _plain_encode(codec, kw, b)
        same = (kernel_words == plain_words).all(dim=1).double().mean().item()
        check(same == 1.0, f"quality_matrix[{r['config']}]: {same:.6f} of "
              "the blocks equal the plain versions")
        plain_db = float(bq._decode_psnr(dec_kind, plain_words, blocks))
        out.append(dict(r, plain_psnr=round(plain_db, 3),
                        identical_frac_vs_plain=same))
    return {"phase": "quality_matrix", "device": smi, "quick": quick,
            "launches": launches, "rows": out,
            "worst_delta_db": min(r["delta_db"] for r in out),
            "seconds": time.perf_counter() - t0}


def phase_sharded(smi, bc1_blocks, bc7_blocks, quick):
    """``shard_encode`` in a world of one on NCCL (one GPU cannot hold two
    ranks): BC1 on the 4096x4096 image's blocks and fast BC7 on the 1K
    photo's, each against the unsharded call on every block."""
    import socket
    import torch.distributed as dist
    from gfx_imagecompress_tpu_torch import kernels
    from gfx_imagecompress_tpu_torch.dist import sharded
    from gfx_imagecompress_tpu_torch.kernels import bc1, bc7_fast
    t0 = time.perf_counter()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ok = sharded.init_multihost(coordinator_address=f"127.0.0.1:{port}",
                                num_processes=1, process_id=0,
                                backend="nccl")
    check(ok and dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "sharded: no NCCL process group of one")
    rows = []
    kernels.reset_launch_counts()
    try:
        for name, fn, x in (("bc1", bc1.encode_bc1_blocks, bc1_blocks),
                            ("bc7_fast", bc7_fast.encode_bc7_fast_blocks,
                             bc7_blocks)):
            words, err, mse = sharded.shard_encode(fn, x)
            torch.cuda.synchronize()
            want_w, want_e = fn(x)
            n = x.shape[0]
            expect = want_e.double().sum().item() / (n * 16)
            check(torch.equal(words, want_w) and torch.equal(err, want_e),
                  f"sharded[{name}]: words or errors differ from the "
                  "unsharded call")
            check(abs(mse - expect) <= 1e-6 * abs(expect),
                  f"sharded[{name}]: mse {mse} against {expect}")
            host = sharded.gather_words(words)
            check(host.dtype == np.uint32 and host.shape == tuple(words.shape),
                  f"sharded[{name}]: gathered {host.dtype} {host.shape}")
            reps = 1 if quick else 5
            rows.append({"encoder": name, "blocks": n, "mse": mse,
                         "mse_unsharded": expect,
                         "sharded_ms": time_ms(lambda: sharded.shard_encode(
                             fn, x), reps),
                         "unsharded_ms": time_ms(lambda: fn(x), reps)})
        got = kernels.launch_counts()
        launches = {k: got[k] for k in ("bc1", "bc7_est", "bc7_fast")}
        for k, v in launches.items():
            check(v > 0, f"sharded: never launched {k}")
    finally:
        dist.destroy_process_group()
    return {"phase": "sharded", "device": smi, "backend": "nccl",
            "world_size": 1, "launches": launches, "encoders": rows,
            "seconds": time.perf_counter() - t0}


def phase_bench(smi, decode):
    """``bench.run()`` twice in this process, with the launch counts set to 0
    before the two runs and read after them: all nine keys present and
    positive, every ``_ops_util`` and ``_hbm_frac`` at most 1.05 (a broken
    timer reads faster than the card can be); ``bench.run`` raises where an
    encoder fails or the sleep guard does not hold. Then each config's words
    against the plain versions on the card, on its first 4,096 blocks (1,024
    for full BC7), and full BC7 on all 262,144 blocks of the 2K image in one
    call: the reported error equal to the decoded error on every block."""
    from gfx_imagecompress_tpu_torch import bench, kernels
    from gfx_imagecompress_tpu_torch.kernels import bc7_full
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    runs = [bench.run(), bench.run()]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for k, v in launches.items():
        check(v > 0, f"bench: the two runs never launched the {k} kernel")
    for i, res in enumerate(runs):
        for key in bench.KEYS:
            v = res.get(key)
            check(isinstance(v, float) and v > 0,
                  f"bench[run {i}]: {key} is {v}")
        for k, v in res.items():
            if k.endswith(("_ops_util", "_hbm_frac")):
                check(v <= 1.05, f"bench[run {i}]: {k} {v} > 1.05")
    ratio = {k: runs[1][k] / runs[0][k] for k in bench.KEYS}
    plain_checked = {}
    for key, encode, kw, blocks, _, _, _ in bench.configs("cuda"):
        plain = getattr(sys.modules[encode.__module__],
                        encode.__name__ + "_plain")
        x = blocks[:1024 if encode is bc7_full.encode_bc7_blocks else 4096]
        same = (encode(x, **kw)[0] == plain(x, **kw)[0]).all(1)
        check(same.all().item(), f"bench[{key}]: words differ from the plain "
              f"versions on {int((~same).sum())} of {x.shape[0]} blocks")
        plain_checked[key] = int(x.shape[0])
        if key == "bc7_full_2k_mtexels_per_s":
            full = blocks
    words, err = bc7_full.encode_bc7_blocks(full)
    dec_err = decoded_error("bc7_full", full, words, {}, decode)
    bad = ((dec_err - err.double()).abs() > 0.5 + 1e-4 * dec_err.abs())
    check(not bad.any().item() and torch.isfinite(err).all().item(),
          f"bench[bc7_full_2k one call]: reported error != decoded error "
          f"(rtol 1e-4, atol 0.5) on {int(bad.sum())} of {full.shape[0]} "
          "blocks")
    return {"phase": "bench", "device": smi, "launches": launches,
            "runs": runs, "run2_over_run1": ratio,
            "plain_blocks_compared": plain_checked,
            "bc7_full_2k_one_call": {"blocks": int(full.shape[0]),
                                     "reported_equals_decoded":
                                     not bad.any().item()},
            "seconds": time.perf_counter() - t0}


def ptxas_summary(logs):
    """Registers, stack and spill bytes per kernel from ``ptxas -v``."""
    out = []
    pat = re.compile(
        r"Compiling entry function '(\S+)' for 'sm_90a'.*?"
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
        r"(\d+) bytes spill loads.*?Used (\d+) registers", re.S)
    for lib, log in logs.items():
        for m in pat.finditer(log):
            k = re.findall(r"bc\d[a-z_]*kernel(?:I(?:L[bi]\d+E)+E)?",
                           m.group(1))
            out.append({"lib": lib, "kernel": k[-1] if k else m.group(1),
                        "registers": int(m.group(5)),
                        "stack_bytes": int(m.group(2)),
                        "spill_store_bytes": int(m.group(3)),
                        "spill_load_bytes": int(m.group(4))})
    return out


# ------------------------------------------------------------------ main ---

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="small sizes: build and correctness only")
    ap.add_argument("--out", default=None,
                    help="directory for results.json and the ptxas logs")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script does not run on the CPU", file=sys.stderr)
        return 1

    import gfx_imagecompress_tpu_torch as gic
    from gfx_imagecompress_tpu_torch import kernels
    from gfx_imagecompress_tpu_torch.decode import bcn as decode
    from gfx_imagecompress_tpu_torch.decode import decode_image
    from gfx_imagecompress_tpu_torch.kernels import (_build, bc1, bc4, bc6h,
                                                     bc7_est, bc7_fast,
                                                     bc7_full)
    from gfx_imagecompress_tpu_torch.api import _rgba as api_rgba
    from gfx_imagecompress_tpu_torch.pipeline.blocks import (image_to_blocks,
                                                             packed_to_grid)
    from gfx_imagecompress_tpu_torch.roofline import (
        bound, bytes_bc7_full, ops_bc6h, ops_bc7_est, ops_bc7_full,
        ops_per_block)

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0] if smi else "nvidia-smi: no output"
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- build
    info = _build.ensure_built()
    resources = ptxas_summary(info["ptxas"])
    emit({"phase": "build", "seconds": info["seconds"],
          "built": info["built"], "resources": resources})
    # the native decode oracle (g++), which the later phases decode through
    from gfx_imagecompress_tpu_torch import native
    native_info = dict(native.ensure_built())

    wrappers = {
        "bc1": (bc1.encode_bc1_blocks, bc1.encode_bc1_blocks_plain),
        "bc2": (bc1.encode_bc2_blocks, bc1.encode_bc2_blocks_plain),
        "bc3": (bc1.encode_bc3_blocks, bc1.encode_bc3_blocks_plain),
        "bc4": (bc4.encode_bc4_blocks, bc4.encode_bc4_blocks_plain),
        "bc5": (bc4.encode_bc5_blocks, bc4.encode_bc5_blocks_plain),
        "bc7_fast": (bc7_fast.encode_bc7_fast_blocks,
                     bc7_fast.encode_bc7_fast_blocks_plain),
        "bc7_full": (bc7_full.encode_bc7_blocks,
                     bc7_full.encode_bc7_blocks_plain),
        "bc6h": (bc6h.encode_bc6h_blocks, bc6h.encode_bc6h_blocks_plain),
    }
    exact = {"bc2": [(0, 2, "BC2 alpha")], "bc3": [(0, 2, "BC3 alpha")],
             "bc4": [(0, 2, "BC4")], "bc5": [(0, 4, "BC5")],
             "bc6h": [(0, 4, "BC6H")]}

    def inputs_for(name, rgba):
        if name == "bc4":
            return rgba[:, :, 0].contiguous()
        if name == "bc5":
            return rgba[:, :, :2].contiguous()
        return rgba

    # ---- kernels vs plain versions on mixed content and hard cases
    n_mixed = 4096 if args.quick else 65536 + 2048
    mixed = torch.from_numpy(mixed_blocks(n_mixed)).to(dev)
    thr = 128 / 255.0
    budgets = [
        ("bc1", "default", {}, n_mixed),
        ("bc1", "use_alpha", {"use_alpha": True, "alpha_threshold": thr},
         n_mixed),
        ("bc1", "four_only", {"allow_three": False}, n_mixed),
        ("bc1", "adaptive", {"adaptive": True}, n_mixed),
        ("bc1", "b3d", {"b3d": True}, 4096),
        ("bc1", "b3d_use_alpha", {"b3d": True, "use_alpha": True,
                                  "alpha_threshold": thr}, 4096),
        ("bc2", "default", {}, n_mixed),
        ("bc2", "passes2", {"passes": 2}, n_mixed),
        ("bc2", "adaptive", {"adaptive": True}, n_mixed),
        ("bc3", "default", {}, n_mixed),
        ("bc3", "passes2", {"passes": 2}, n_mixed),
        ("bc3", "adaptive", {"adaptive": True}, n_mixed),
        ("bc3", "alpha_r1", {"a_radius": 1, "a_rounds": 1}, n_mixed),
        ("bc4", "default", {}, n_mixed),
        ("bc4", "r1", {"radius": 1, "rounds": 1}, n_mixed),
        ("bc4", "r3", {"radius": 3, "rounds": 3}, n_mixed),
        ("bc5", "default", {}, n_mixed),
        ("bc5", "r1", {"radius": 1, "rounds": 1}, n_mixed),
        ("bc5", "r3", {"radius": 3, "rounds": 3}, n_mixed),
        ("bc7_fast", "default", {}, n_mixed),
        ("bc7_fast", "fast", {"fast": True}, n_mixed),
        ("bc7_fast", "rgb_metric", {"perceptual": False}, n_mixed),
        ("bc7_fast", "fast_rgb_metric", {"fast": True, "perceptual": False},
         n_mixed),
        ("bc7_full", "q1", {}, n_mixed),
        ("bc7_full", "q05", {"quality": 0.5}, n_mixed),
        ("bc7_full", "q025", {"quality": 0.25}, n_mixed),
        ("bc7_full", "q1_performance03", {"performance": 0.3}, n_mixed),
        ("bc7_full", "q05_unrestricted",
         {"quality": 0.5, "colour_restrict": False, "alpha_restrict": False},
         n_mixed),
        *[("bc7_full", f"q1_mode{m}", {"mode_mask": 1 << m}, 8192)
          for m in range(8)],
        # BC6H: every quality tier unsigned and signed, and at the top tier
        # one region only, transformed two-region modes only (the solid-mean
        # fallback), mode 10 only, mode 14 only
        *[("bc6h", f"q{qq}_{'signed' if sg else 'unsigned'}",
           {"quality": qq, "signed": sg}, n_mixed)
          for qq in (0.3, 0.7, 0.8, 1.0) for sg in (False, True)],
        *[("bc6h", f"q1_mask{mk:04x}", {"mode_mask": mk}, n_mixed)
          for mk in (0x3C00, 0x1FF, 0x200, 0x2000)],
    ]
    # BC7 takes mode 1 only for opaque blocks: every other block is made
    # opaque so both modes meet every kind of content
    mixed7 = mixed.clone()
    mixed7[::2, :, 3] = 1.0
    hdr_mixed = {sg: torch.from_numpy(mixed_hdr_blocks(
        n_mixed, signed=sg)).to(dev) for sg in (False, True)}
    rows = []
    extras = {"bc7_fast": alpha_blocks_take_mode6,
              "bc7_full": barred_blocks_avoid_modes_6_7,
              "bc6h": bc6h_modes_enabled}
    for name, label, kw, n in budgets:
        wrapper, plain = wrappers[name]
        bc7 = name.startswith("bc7")
        if name == "bc6h":
            x = hdr_mixed[kw.get("signed", False)][:n].contiguous()
        else:
            x = inputs_for(name, (mixed7 if bc7 else mixed)[:n].contiguous())
        rows.append(compare(name, label, wrapper, plain, x, kw, decode,
                            reps=1 if args.quick else 3,
                            exact_cols=exact.get(name, ()),
                            extra=extras.get(name)))
    # the shortlist kernel in the configurations of the fast path and of the
    # full BC7 encoder's 3-subset and mode-7 rankings
    est_cfgs = [
        ("rgb_2sub_64_k4", dict(chans=3, subsets=2, plist=tuple(range(64)),
                                levels=8, k=4)),
        ("rgb_2sub_fast24_k2", dict(chans=3, subsets=2,
                                    plist=bc7_fast.FAST_PARTITIONS,
                                    levels=8, k=2)),
        ("rgb_3sub_16_k4", dict(chans=3, subsets=3, plist=tuple(range(16)),
                                levels=4, k=4)),
        ("rgba_2sub_64_k8_pca", dict(chans=4, subsets=2,
                                     plist=tuple(range(64)), levels=4, k=8,
                                     estimator="pca")),
        ("rgb_3sub_64_k8", dict(chans=3, subsets=3, plist=tuple(range(64)),
                                levels=4, k=8)),
        ("rgb_3sub_16_l8_k8", dict(chans=3, subsets=3,
                                   plist=tuple(range(16)), levels=8, k=8)),
        ("rgb_2sub_64_k9", dict(chans=3, subsets=2, plist=tuple(range(64)),
                                levels=8, k=9)),
    ]
    for label, cfg in est_cfgs:
        rows.append(compare_est(label, bc7_est, mixed7, cfg,
                                reps=1 if args.quick else 3))
    # mode 7's shortlist with the full BC7 entry's mode 6/7 bar: barred
    # blocks get the list's first k ids, the others their ranking
    bar7 = bc7_full._combined_alpha_bar(mixed7, True, True)
    barred = bar7.double().mean().item()
    check(0.0 < barred < 1.0, f"bc7_est[barred]: barred share {barred} of "
          "the mixed blocks is not strictly between 0 and 1")
    rows.append(dict(compare_est(
        "rgba_2sub_64_k8_pca_barred", bc7_est, mixed7,
        dict(chans=4, subsets=2, plist=tuple(range(64)), levels=4, k=8,
             estimator="pca", bar=bar7), reps=1 if args.quick else 3),
        barred_frac=barred))
    emit({"phase": "kernel_budgets", "device": smi, "quick": args.quick,
          "budgets": rows})

    # ---- main path: compress() at the sizes BASELINE.json names
    q = args.quick
    side_big = 256 if q else 4096
    bc7 = gic.CompressType.DXBC7
    side7 = 128 if q else 1024
    cases = [
        # name, ctype, image (S,H,W,C), PSNR floor in dB, checked channels;
        # a BC7 case's floor is set below from the plain version
        ("bc1_64x256", gic.CompressType.DXBC1,
         np.stack([photo_rgba(256, 256, seed=s) for s in
                   range(4 if q else 64)]), 30.0, 3),
        (f"bc1_{side_big}", gic.CompressType.DXBC1,
         photo_rgba(side_big, side_big, seed=100)[None], 30.0, 3),
        ("bc4_512", gic.CompressType.DXBC4,
         photo_rgba(512, 512, seed=101)[None, ..., :1], 35.0, 1),
        ("bc5_512", gic.CompressType.DXBC5,
         photo_rgba(512, 512, seed=102)[None, ..., :2], 35.0, 2),
        ("bc2_1k", gic.CompressType.DXBC2,
         with_alpha_field(photo_rgba(1024, 1024, seed=103), 3)[None],
         28.0, 4),
        ("bc3_1k", gic.CompressType.DXBC3,
         with_alpha_field(photo_rgba(1024, 1024, seed=104), 4)[None],
         30.0, 4),
        ("bc1_npot_13x257", gic.CompressType.DXBC1,
         photo_rgba(13, 257, seed=105)[None], 30.0, 3),
        (f"bc7_fast_{side7}", bc7,
         photo_rgba(side7, side7, seed=110)[None], None, 3),
        (f"bc7_fast_{2 * side7}", bc7,
         photo_rgba(2 * side7, 2 * side7, seed=111)[None], None, 3),
        (f"bc7_fast_budget_fast_{side7}", "richgel_fast",
         photo_rgba(side7, side7, seed=110)[None], None, 3),
        (f"bc7_fast_alpha_{side7}", bc7,
         with_alpha_field(photo_rgba(side7, side7, seed=112), 6)[None],
         None, 4),
        ("bc7_fast_npot_13x257", bc7,
         photo_rgba(13, 257, seed=113)[None], None, 3),
        # full BC7 on the same images as the fast path
        (f"bc7_full_{side7}", "bc7_full",
         photo_rgba(side7, side7, seed=110)[None], None, 3),
        (f"bc7_full_{2 * side7}", "bc7_full",
         photo_rgba(2 * side7, 2 * side7, seed=111)[None], None, 3),
        (f"bc7_full_alpha_{side7}", "bc7_full",
         with_alpha_field(photo_rgba(side7, side7, seed=112), 6)[None],
         None, 4),
        ("bc7_full_npot_13x257", "bc7_full",
         photo_rgba(13, 257, seed=113)[None], None, 3),
    ]

    def encode(ctype, img):
        if ctype == "richgel_fast":
            return gic.compress_richgel999_bc7(
                img, gic.RichGel999Options(fast=True))
        if ctype == "bc7_full":
            return gic.compress(bc7, img)
        return gic.compress(ctype, img, fast=ctype == bc7)

    def bc7_floor(ctype, img, nch):
        """PSNR floor of a BC7 case: what the plain version reaches on the
        image's top-left 256x256 pixels (or all of a smaller image), less
        0.5 dB."""
        crop = gic.Image(data=img.data[:, :256, :256].contiguous(),
                         srgb=img.srgb)
        blocks = api_rgba(image_to_blocks(crop.data))
        if ctype == "bc7_full":
            words, _ = bc7_full.encode_bc7_blocks_plain(blocks)
        else:
            words, _ = bc7_fast.encode_bc7_fast_blocks_plain(
                blocks, fast=ctype == "richgel_fast")
        dec = decode_image(gic.CompressedImage(
            packed_to_grid(words, crop.slices, crop.height, crop.width, 4),
            gic.BlockFormat.BC7_UNORM, crop.width, crop.height, crop.slices))
        src = torch.round(crop.data * 255.0)
        return psnr(dec[..., :nch], src[..., :nch]) - 0.5

    main_rows = []
    shape_inputs = {}
    # (label, decoder key, words) of every output the main path emitted, for
    # the native_oracle phase
    emitted = []
    dec_key = {gic.CompressType.DXBC1: "bc1", gic.CompressType.DXBC2: "bc2",
               gic.CompressType.DXBC3: "bc3", gic.CompressType.DXBC4: "bc4",
               gic.CompressType.DXBC5: "bc5", bc7: "bc7",
               "richgel_fast": "bc7", "bc7_full": "bc7"}

    def drive(label, ctype, arr, floor_db, nch):
        img = gic.Image.from_array(np.ascontiguousarray(arr))   # device=None
        check(img.device.type == "cuda", f"{label}: image not on the card")
        if floor_db is None:
            floor_db = bc7_floor(ctype, img, nch)
        out = encode(ctype, img)
        torch.cuda.synchronize()
        dec = decode_image(out, force_four=False)
        src = torch.round(img.data * 255.0)
        db = psnr(dec[..., :nch], src[..., :nch])
        s, h, w, _ = arr.shape
        by, bx = (h + 3) // 4, (w + 3) // 4
        wpb = 2 if ctype in (gic.CompressType.DXBC1,
                             gic.CompressType.DXBC4) else 4
        check(tuple(out.blocks.shape) == (s, by, bx, wpb),
              f"{label}: grid shape {tuple(out.blocks.shape)}")
        check(out.blocks.device.type == "cuda", f"{label}: blocks not on card")
        check(len(out.tobytes()) == s * by * bx * wpb * 4,
              f"{label}: byte length")
        check(np.isfinite(db) and db > floor_db,
              f"{label}: PSNR {db:.2f} dB <= {floor_db}")
        texels = s * h * w
        # short calls are timed over more repeats: they are mostly launch
        # cost; the full BC7 search is long at any size
        if ctype == "bc7_full":
            reps = 1 if q or texels > 2e6 else 2
        else:
            reps = 1 if q else (3 if texels > 4e6 else 20)
        ms = time_ms(lambda: encode(ctype, img), reps)
        main_rows.append({"case": label, "blocks": s * by * bx,
                          "psnr_db": db, "psnr_floor_db": floor_db,
                          "compress_ms": ms,
                          "mtexel_per_s": texels / ms / 1e3})
        shape_inputs[label] = image_to_blocks(img.data)
        emitted.append((label, dec_key[ctype], out.blocks))

    def card_equals_cpu(ctype, arr):
        """Small input: the card's output against the plain versions on the
        CPU."""
        a = encode(ctype, gic.Image.from_array(arr))
        b = encode(ctype, gic.Image.from_array(arr, device="cpu"))
        check(a.tobytes() == b.tobytes(),
              f"{getattr(ctype, 'name', ctype)}: card output differs from the "
              "CPU plain version on a 64x64 image")

    def launched(names):
        """The counts of the path just driven: every kernel of it > 0."""
        got = kernels.launch_counts()
        for name in names:
            check(got[name] > 0,
                  f"main path never launched the {name} kernel")
        return {name: got[name] for name in names}

    path_of = [2 if c[1] in (bc7, "richgel_fast") else
               3 if c[1] == "bc7_full" else 1 for c in cases]
    small = with_alpha_field(photo_rgba(64, 64, seed=107), 5)

    # Each path is driven with the counts set to 0 just before it and read
    # just after. First path: compress() for BC1-BC5.
    kernels.reset_launch_counts()
    for case, path in zip(cases, path_of):
        if path == 1:
            drive(*case)

    # punch-through: decoded alpha bit-exact against the mask
    pimg = photo_rgba(256, 256, seed=106)
    yy, xx = np.mgrid[0:256, 0:256]
    pimg[..., 3] = ((xx // 4 + yy // 4) % 2).astype(np.float32)
    pimg[::7, ::5, 3] = np.float32(128 / 255.0)        # exactly at threshold
    pimg[::11, ::3, 3] = np.float32(127 / 255.0)       # just below
    img = gic.Image.from_array(pimg)
    out = gic.compress_amd_bc1(
        img, options=gic.BC1Options(use_alpha=True, alpha_threshold=128))
    dec = decode_image(out)
    opaque = (img.data[..., 3] * 255.0) >= 128.0
    check(((dec[..., 3] > 127) == opaque).all().item(),
          "punch-through: decoded alpha differs from the mask")
    db = psnr(dec[..., :3][opaque], torch.round(img.data[..., :3] * 255)[opaque])
    check(db > 30.0, f"punch-through: opaque PSNR {db:.2f} dB <= 30")
    main_rows.append({"case": "bc1_punch_256", "blocks": 4096, "psnr_db": db})
    emitted.append(("bc1_punch_256", "bc1", out.blocks))

    for ctype in (gic.CompressType.DXBC1, gic.CompressType.DXBC2,
                  gic.CompressType.DXBC3, gic.CompressType.DXBC4,
                  gic.CompressType.DXBC5):
        card_equals_cpu(ctype, small)
    counts = launched(("bc1", "bc2", "bc3", "bc4", "bc5"))

    # Second path: the fast BC7 encoder, through compress(DXBC7, fast=True)
    # and compress_richgel999_bc7.
    kernels.reset_launch_counts()
    for case, path in zip(cases, path_of):
        if path == 2:
            drive(*case)
    card_equals_cpu(bc7, small)
    card_equals_cpu(bc7, photo_rgba(64, 64, seed=108))
    counts.update(launched(("bc7_est", "bc7_fast")))

    # Third path: the full BC7 encoder, through compress(DXBC7) (quality 1.0,
    # all eight modes). Its shortlist launches are counted again from 0.
    kernels.reset_launch_counts()
    for case, path in zip(cases, path_of):
        if path == 3:
            drive(*case)
    card_equals_cpu("bc7_full", small)
    card_equals_cpu("bc7_full", photo_rgba(64, 64, seed=108))
    full_counts = launched(("bc7_est", "bc7_full"))
    full_est_by_config = dict(bc7_est.LAUNCHES_BY_CONFIG)
    counts["bc7_full"] = full_counts["bc7_full"]
    counts["bc7_est_full_path"] = full_counts["bc7_est"]
    # Fourth path: BC6H through compress(DXBC6H) (quality 1.0, all 14
    # modes), unsigned and signed, from float16 RGBA textures as an RGBA16F
    # file holds them.
    bc6h_calls = [0]

    def encode_hdr(img):
        if img.device.type == "cuda":
            bc6h_calls[0] += 1
        return gic.compress(gic.CompressType.DXBC6H, img)

    def hdr_psnr(out, img):
        """HDR PSNR as the JAX package's quality bench defines it: decoded
        half floats against the float32 source, peak = max - min(min, 0)."""
        dec = decode_image(out)
        src = img.data[..., :3].double()
        peak = src.max().item() - min(src.min().item(), 0.0)
        mse = torch.mean((dec.double() - src) ** 2).item()
        return 10.0 * np.log10(peak ** 2 / max(mse, 1e-12))

    def bc6h_floor(img):
        """The plain version's HDR PSNR on the image's top-left 256x256
        pixels (or all of a smaller image), on the card, less 0.5 dB."""
        crop = gic.Image(data=img.data[:, :256, :256].contiguous(),
                         signed=img.signed, hdr=True)
        blocks = image_to_blocks(crop.data)[:, :, :3].contiguous()
        words, _ = bc6h.encode_bc6h_blocks_plain(blocks, signed=img.signed)
        fmt = (gic.BlockFormat.BC6H_SFLOAT if img.signed
               else gic.BlockFormat.BC6H_UFLOAT)
        out = gic.CompressedImage(
            packed_to_grid(words, crop.slices, crop.height, crop.width, 4),
            fmt, crop.width, crop.height, crop.slices)
        return hdr_psnr(out, crop) - 0.5

    def rgba16f(rgb):
        """An RGB float field as the float16 RGBA texture a user hands in."""
        a = np.ones(rgb.shape[:-1] + (1,), np.float32)
        return np.concatenate([rgb, a], -1).astype(np.float16)

    def drive_bc6h(label, arr, signed):
        img = gic.Image.from_array(np.ascontiguousarray(arr), signed=signed,
                                   hdr=True)                    # device=None
        check(img.device.type == "cuda", f"{label}: image not on the card")
        floor_db = bc6h_floor(img)
        before = kernels.launch_counts()["bc6h"]
        out = encode_hdr(img)
        torch.cuda.synchronize()
        check(kernels.launch_counts()["bc6h"] == before + 1,
              f"{label}: compress() did not launch the BC6H kernel once")
        want_fmt = (gic.BlockFormat.BC6H_SFLOAT if signed
                    else gic.BlockFormat.BC6H_UFLOAT)
        check(out.format == want_fmt, f"{label}: format {out.format}")
        db = hdr_psnr(out, img)
        s_, h, w, _ = arr.shape
        by, bx = (h + 3) // 4, (w + 3) // 4
        check(tuple(out.blocks.shape) == (s_, by, bx, 4),
              f"{label}: grid shape {tuple(out.blocks.shape)}")
        check(out.blocks.device.type == "cuda", f"{label}: blocks not on card")
        check(len(out.tobytes()) == s_ * by * bx * 16,
              f"{label}: byte length")
        check(np.isfinite(db) and db > floor_db,
              f"{label}: HDR PSNR {db:.2f} dB <= {floor_db:.2f}")
        texels = s_ * h * w
        ms = time_ms(lambda: encode_hdr(img), 1 if q else 20)
        hdr_images[label] = img
        main_rows.append({"case": label, "blocks": s_ * by * bx,
                          "psnr_db": db, "psnr_floor_db": floor_db,
                          "compress_ms": ms,
                          "mtexel_per_s": texels / ms / 1e3})
        shape_inputs[label] = image_to_blocks(img.data)[:, :, :3].contiguous()
        emitted.append((label, "bc6h_sf" if signed else "bc6h_uf", out.blocks))

    hdr_images = {}
    kernels.reset_launch_counts()
    photo_hdr = np.exp(photo_rgba(side7, side7, seed=120)[..., :3] * 4.0)
    signed_hdr = photo_hdr.copy()
    signed_hdr[..., 1] *= -1.0
    drive_bc6h(f"bc6h_uf_{side7}", rgba16f(photo_hdr)[None], False)
    drive_bc6h(f"bc6h_sf_{side7}", rgba16f(signed_hdr)[None], True)
    drive_bc6h("bc6h_uf_npot_13x257",
               rgba16f(np.exp(photo_rgba(13, 257, seed=121)[..., :3]
                              * 4.0))[None], False)
    for sg in (False, True):
        small_hdr = hdr_field(64, 64, seed=122, signed=sg)
        a = encode_hdr(gic.Image.from_array(small_hdr, signed=sg, hdr=True))
        b = encode_hdr(gic.Image.from_array(small_hdr, signed=sg, hdr=True,
                                            device="cpu"))
        check(a.tobytes() == b.tobytes(),
              f"DXBC6H signed={sg}: card output differs from the CPU plain "
              "version on a 64x64 image")
    got = kernels.launch_counts()["bc6h"]
    check(got == bc6h_calls[0] and got > 0,
          f"BC6H path: {got} kernel launches for {bc6h_calls[0]} compress() "
          "calls on the card")
    counts["bc6h"] = got
    counts["bc6h_compress_calls"] = bc6h_calls[0]

    psnr_of = {r["case"]: r["psnr_db"] for r in main_rows}
    check(psnr_of[f"bc7_full_{side7}"] >= psnr_of[f"bc7_fast_{side7}"],
          f"bc7_full_{side7}: RGB PSNR {psnr_of[f'bc7_full_{side7}']:.3f} dB "
          f"below the fast path's {psnr_of[f'bc7_fast_{side7}']:.3f} dB")
    emit({"phase": "main_path", "device": smi, "quick": args.quick,
          "launches": counts, "cases": main_rows})

    # ---- each kernel at the shape the main path gives it: time, bound,
    # and once more against the plain version
    shape_of = {"bc1": f"bc1_{side_big}", "bc2": "bc2_1k", "bc3": "bc3_1k",
                "bc4": "bc4_512", "bc5": "bc5_512",
                "bc7_fast": f"bc7_fast_{side7}",
                "bc7_full": f"bc7_full_{side7}", "bc6h": f"bc6h_uf_{side7}"}
    # bytes per block: the input read once, words and error written once;
    # the shortlist's ids (4 per block on the main path) written by bc7_est
    # and read by bc7_fast
    meta = {
        "bc7_est": ("gfx_imagecompress_tpu_torch/csrc/bc7_est_kernel.cu",
                    "gfx_imagecompress_tpu/kernels/bc7_full_pallas.py:965",
                    256 + 16),
        "bc7_fast": ("gfx_imagecompress_tpu_torch/csrc/bc7_fast_kernel.cu",
                     "gfx_imagecompress_tpu/kernels/bc7_fast_pallas.py:692",
                     256 + 16 + 20),
        # the kernel template; bc7_full_m02/m1367/m45_kernel.cu instantiate it
        "bc7_full": ("gfx_imagecompress_tpu_torch/csrc/bc7_full_search.cuh",
                     "gfx_imagecompress_tpu/kernels/bc7_full_pallas.py:1015",
                     None),
        # the (N,16,3) int32 half-ints read once, words and error written
        "bc6h": ("gfx_imagecompress_tpu_torch/csrc/bc6h_kernel.cu",
                 "gfx_imagecompress_tpu/kernels/bc6h_pallas.py:475",
                 192 + 20),
        "bc1": ("gfx_imagecompress_tpu_torch/csrc/bc1_kernel.cu",
                "gfx_imagecompress_tpu/kernels/bc1_pallas.py:534", 268),
        # the kernels sit in bc23_group.cuh; bc23_kernels.cu launches them
        "bc2": ("gfx_imagecompress_tpu_torch/csrc/bc23_group.cuh",
                "gfx_imagecompress_tpu/kernels/bc1_pallas.py:635", 276),
        "bc3": ("gfx_imagecompress_tpu_torch/csrc/bc23_group.cuh",
                "gfx_imagecompress_tpu/kernels/bc1_pallas.py:612", 276),
        # the kernels sit in bc45_group.cuh; bc45_kernels.cu launches them
        "bc4": ("gfx_imagecompress_tpu_torch/csrc/bc45_group.cuh",
                "gfx_imagecompress_tpu/kernels/bc4_pallas.py:265", 76),
        "bc5": ("gfx_imagecompress_tpu_torch/csrc/bc45_group.cuh",
                "gfx_imagecompress_tpu/kernels/bc4_pallas.py:274", 148),
    }

    def kernel_row(name, r, x, ops_pb, bytes_pb=None, **more):
        source, replaces, fixed_bytes = meta[name]
        bytes_pb = fixed_bytes if bytes_pb is None else bytes_pb
        b_ms, b_by = bound(x.shape[0], bytes_pb, ops_pb)
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "n_blocks": r["n_blocks"],
            "share_of_bound": b_ms / r["kernel_ms"],
            "identical_frac": r["identical_frac"],
            "bytes_per_block": bytes_pb, "ops_per_block": ops_pb, **more}

    def full_kernel_row(x, reps):
        """The full search's eight launches of one compress() chunk, on the
        main path's shortlists. ``ms`` is the eight launches as the path runs
        them, right after the chunk's three shortlist launches (not timed);
        ``ms_alone`` the eight back to back on shortlists computed once; then
        each mode alone, and once more against the plain version. The three
        shortlists get rows of their own (``full_est_rows``)."""
        plan = bc7_full._plan(1.0, 0xFF, 1.0, None, None, None, None)
        bar = bc7_full._combined_alpha_bar(x, True, True)
        cfgs = {tuple(sorted(cfg.items())): cfg
                for cfg in plan.shortlists.values() if isinstance(cfg, dict)}
        pre = {key: bc7_est.estimate_topk(x, **cfg)
               for key, cfg in cfgs.items()}

        def given(blocks, bar=None, **cfg):
            return pre[tuple(sorted(cfg.items()))]

        def searches(fn):
            return lambda x: bc7_full._encode(x, plan, bar, given, fn)

        def shortlists():
            for key, cfg in cfgs.items():
                pre[key] = bc7_est.estimate_topk(x, **cfg)

        path_ms = launch_ms(shortlists, lambda: searches(
            bc7_full.bc7_mode_search)(x), reps)
        per_mode = {}
        for m in plan.modes:
            cfg = plan.shortlists.get(m)
            ids = given(x, **cfg) if isinstance(cfg, dict) else cfg
            per_mode[m] = time_ms(lambda: bc7_full.bc7_mode_search(
                x, m, ids, iters=plan.iters, shake=plan.shake, uber=plan.uber,
                keep=plan.keep, bar=bar if m >= 6 else None), reps)
        r = compare("bc7_full", "main_shape",
                    searches(bc7_full.bc7_mode_search),
                    searches(bc7_full.bc7_mode_search_plain), x, {}, decode,
                    reps=reps, extra=barred_blocks_avoid_modes_6_7)
        unbarred = 1.0 - bar.double().mean().item()
        bytes_pb = bytes_bc7_full(unbarred, plan.shortlists[1]["k"])
        regs = [res for res in resources if res["lib"].startswith("bc7_full")]
        return kernel_row("bc7_full", dict(r, kernel_ms=path_ms), x,
                          ops_bc7_full(unbarred), bytes_pb=bytes_pb,
                          ms_alone=r["kernel_ms"], per_mode_ms=per_mode,
                          blocks_per_mode=r["blocks_per_mode"],
                          unbarred_frac=unbarred,
                          lanes_per_block={m: bc7_full.LAUNCH_SHAPES[m][0]
                                           for m in plan.modes},
                          threads_per_cta={m: bc7_full.LAUNCH_SHAPES[m][1]
                                           for m in plan.modes},
                          lanes_per_block_without_refinement={
                              m: bc7_full.NARROW_SHAPES[m][0]
                              for m in plan.modes},
                          threads_per_cta_without_refinement={
                              m: bc7_full.NARROW_SHAPES[m][1]
                              for m in plan.modes},
                          resources=regs)

    def full_est_rows(x, reps):
        """The three shortlist launches of a full-BC7 chunk at the main
        path's shape, each against its plain version: modes 1/3, mode 2,
        mode 7. ``launches`` is what the wrapper counted for that
        configuration while the full path ran."""
        plan = bc7_full._plan(1.0, 0xFF, 1.0, None, None, None, None)
        cfgs = {tuple(sorted(cfg.items())): cfg
                for cfg in plan.shortlists.values() if isinstance(cfg, dict)}
        out = []
        for cfg in cfgs.values():
            label = (f"full_{cfg['chans']}ch_{cfg['subsets']}sub_"
                     f"l{cfg['levels']}_k{cfg['k']}"
                     + ("_pca" if cfg.get("estimator") == "pca" else ""))
            r = compare_est(label, bc7_est, x, cfg, reps)
            row = kernel_row("bc7_est", r, x, ops_bc7_est(
                chans=cfg["chans"], subsets=cfg["subsets"],
                nparts=len(cfg["plist"]), k=cfg["k"],
                pca=cfg.get("estimator") == "pca"),
                bytes_pb=256 + 4 * cfg["k"], config=label, **est_shape)
            row["launches"] = full_est_by_config.get(
                bc7_est.config_key(**cfg), 0)
            check(row["launches"] > 0,
                  f"main path never launched the {label} shortlist")
            out.append(row)
        # mode 7's shortlist as the path runs it, with the mode 6/7 bar: on
        # the photo (every block barred) and on the alpha-field image
        # (partly barred). Operations and bytes are those of this run's
        # data: a barred block reads its bar byte and writes k ids.
        cfg = plan.shortlists[7]
        key = bc7_est.config_key(**cfg)
        label = "full_4ch_2sub_l4_k8_pca_barred"
        # A barred launch is shorter than the host takes to issue it: its
        # time is taken with the launches queued (queued_ms); the time of
        # the wrapper called back to back stays beside it.
        sides = {}
        for side, xx in (("photo", x),
                         ("alpha", shape_inputs[f"bc7_full_alpha_{side7}"])):
            bar = bc7_full._combined_alpha_bar(xx, True, True)
            free = 1.0 - bar.double().mean().item()
            r = compare_est(f"{label}_{side}", bc7_est, xx,
                            dict(cfg, bar=bar), reps)
            r["wrapper_ms"] = r["kernel_ms"]
            r["kernel_ms"] = queued_ms(lambda: bc7_est.estimate_topk(
                xx, **cfg, bar=bar), reps)
            sides[side] = (xx, free, r)
        xx, free, r = sides["photo"]
        xa, free_a, ra = sides["alpha"]
        ops = ops_bc7_est(chans=4, subsets=2, nparts=len(cfg["plist"]),
                          k=cfg["k"], pca=True)
        row = kernel_row("bc7_est", r, xx, free * ops,
                         bytes_pb=1 + 4 * cfg["k"] + free * 256,
                         config=label, barred_frac=1.0 - free,
                         wrapper_ms=r["wrapper_ms"],
                         alpha_image_ms=ra["kernel_ms"],
                         alpha_image_plain_ms=ra["plain_ms"],
                         alpha_image_barred_frac=1.0 - free_a,
                         alpha_image_identical_frac=ra["identical_frac"],
                         alpha_image_bound_ms=bound(
                             xa.shape[0], 1 + 4 * cfg["k"] + free_a * 256,
                             free_a * ops)[0], **est_shape)
        row["launches"] = full_est_by_config.get(key, 0)
        out.append(row)
        return out

    def bc6h_kernel_row(reps):
        """K6 on the half-ints of the main path's 1K images, unsigned and
        signed, against its plain version; the row is the unsigned image's,
        the signed one beside. ``ms`` is K6's launch as the main path runs
        it, right after the half conversion (``encode_bc6h_blocks``), the
        conversion not timed; ``ms_alone`` is K6 back to back on one tensor
        of half-ints (the two differ: PERF.md). Around the comparison, the
        whole compress() call and K6 alone are timed again
        (``around_plain``): before and after the plain version."""
        budget = dict(zip(("topk", "iters", "shake"), bc6h._budgets(1.0)))
        res, around, main_ms = {}, {}, {}
        for sg in (False, True):
            label = f"bc6h_{'sf' if sg else 'uf'}_{side7}"
            x, img = shape_inputs[label], hdr_images[label]
            h = bc6h.f32_to_half_int(x, sg).contiguous()
            compress_before = time_ms(lambda: encode_hdr(img), reps)
            hc = [h]

            def convert(x=x, sg=sg):
                hc[0] = bc6h.f32_to_half_int(x, sg).contiguous()

            main_ms[sg] = launch_ms(convert, lambda: bc6h.bc6h_search(
                hc[0], signed=sg, mode_mask=0xFFFF, **budget), reps)

            def search(xx, signed, h=h):
                return bc6h.bc6h_search(h, signed=signed, mode_mask=0xFFFF,
                                        **budget)

            def search_plain(xx, signed, h=h):
                return bc6h.bc6h_search_plain(h, signed=signed,
                                              mode_mask=0xFFFF, **budget)

            res[sg] = (x, compare(
                "bc6h", f"main_shape_{'signed' if sg else 'unsigned'}",
                search, search_plain, x, {"signed": sg}, decode, reps=reps,
                exact_cols=exact["bc6h"], extra=bc6h_modes_enabled))
            around["signed" if sg else "unsigned"] = {
                "compress_ms_before": compress_before,
                "kernel_ms_before": res[sg][1]["kernel_ms"],
                "kernel_ms_after": time_ms(
                    lambda: search(None, sg), reps),
                "compress_ms_after": time_ms(lambda: encode_hdr(img), reps)}
        x, r = res[False]
        rs = res[True][1]
        regs = [k for k in resources if k["lib"] == "bc6h"]
        return kernel_row(
            "bc6h", dict(r, kernel_ms=main_ms[False]), x, ops_bc6h(**budget),
            launches_per_compress=1, ms_alone=r["kernel_ms"],
            signed_ms=main_ms[True], signed_ms_alone=rs["kernel_ms"],
            signed_plain_ms=rs["plain_ms"],
            signed_identical_frac=rs["identical_frac"],
            signed_max_abs_err=rs["max_abs_err"],
            blocks_per_mode=r["blocks_per_mode"],
            signed_blocks_per_mode=rs["blocks_per_mode"],
            around_plain=around,
            lanes_per_block=bc6h.BC6H_LANES,
            threads_per_cta=bc6h.BC6H_THREADS, resources=regs)

    # K3's launch shape and resources, beside each of its rows
    est_shape = dict(lanes_per_block=bc7_est.EST_LANES,
                     threads_per_cta=bc7_est.EST_THREADS,
                     resources=[k for k in resources
                                if k["lib"] == "bc7_est"])
    final = []
    for name, (wrapper, plain) in wrappers.items():
        if name == "bc6h":
            final.append(bc6h_kernel_row(1 if q else 20))
            continue
        blocks = shape_inputs[shape_of[name]]
        x = blocks[:, :, 0].contiguous() if name == "bc4" else blocks
        reps = 1 if q else (5 if x.shape[0] > 2e5 else 20)
        if name == "bc7_fast":
            # the main path's two launches, each alone: the shortlist, then
            # the search on the shortlist's ids
            cfg = dict(chans=3, subsets=2, plist=tuple(range(64)), levels=8,
                       k=4)
            final.append(kernel_row(
                "bc7_est", compare_est("main_shape", bc7_est, x, cfg, reps),
                x, ops_bc7_est(), **est_shape))
            ids = bc7_est.estimate_topk(x, **cfg)

            def wrapper(x, ids=ids):
                return bc7_fast.bc7_fast_search(x, ids)

            def plain(x, ids=ids):
                return bc7_fast.bc7_fast_search_plain(x, ids, perceptual=True,
                                                      uber=4)
        if name == "bc7_full":
            final.append(full_kernel_row(x, 1 if q else 3))
            final.extend(full_est_rows(x, 1 if q else 20))
            continue
        r = compare(name, "main_shape", wrapper, plain, x, {}, decode,
                    reps=reps, exact_cols=exact.get(name, ()))
        more = {}
        if name == "bc1":
            # K1a: two lanes per block and colour mode, the two modes in
            # different warps (bc1.BC1_LANES, bc1.BC1_CTA_BLOCKS); with b3d
            # the cube on a whole warp (bc1.BC1_CUBE_LANES)
            more = dict(lanes_per_block_and_mode=bc1.BC1_LANES,
                        cube_lanes_per_block_and_mode=bc1.BC1_CUBE_LANES,
                        lanes_per_block=2 * bc1.BC1_LANES,
                        blocks_per_cta=bc1.BC1_CTA_BLOCKS,
                        threads_per_cta=2 * bc1.BC1_CTA_BLOCKS
                        * bc1.BC1_LANES,
                        resources=[k for k in resources
                                   if k["lib"] == "bc1"])
        if name in ("bc2", "bc3"):
            # K1b: the colour half on K1a's 4-colour groups, each alpha
            # family in a warp of its own, one thread per block and family;
            # K1c: one thread per block
            more = dict(resources=[k for k in resources
                                   if k["lib"] == "bc23"
                                   and k["kernel"].startswith(name)])
            if name == "bc3":
                more.update(lanes_per_block=bc1.BC1_LANES + 2,
                            blocks_per_cta=bc1.BC1_CTA_BLOCKS,
                            threads_per_cta=bc1.BC3_THREADS)
            else:
                more.update(lanes_per_block=1, threads_per_cta=128)
        if name in ("bc4", "bc5"):
            # K2a / K2b: 2 * lanes per block and channel (one ramp family on
            # each half), BC5's two channels side by side
            nch = 1 if name == "bc4" else 2
            lanes = bc4.BC45_LANES
            more = dict(lanes_per_block_and_family=lanes,
                        lanes_per_block=2 * nch * lanes,
                        threads_per_cta=bc4.BC45_THREADS,
                        blocks_per_cta=bc4.BC45_THREADS // (2 * nch * lanes),
                        resources=[k for k in resources
                                   if k["lib"] == "bc45"
                                   and k["kernel"].startswith(name)])
        if name == "bc7_fast":
            more = dict(lanes_per_block=bc7_fast.FAST_LANES,
                        threads_per_cta=bc7_fast.FAST_THREADS,
                        resources=[k for k in resources
                                   if k["lib"] == "bc7_fast"])
        final.append(kernel_row(name, r, x, ops_per_block(name, x), **more))

    # ---- the block API, the native oracle, the quality matrix and the
    # sharded encode; each path is driven with the counts set to 0 just
    # before it and read just after
    later = {}
    rgba1k = shape_inputs[f"bc7_fast_{side7}"]
    alpha1k = shape_inputs["bc3_1k"][:, :, 3].contiguous()
    later["block_api"], api_words = phase_block_api(smi, rgba1k, alpha1k, q)
    emit(later["block_api"])
    for name, key in (("rgb_single_mode", "bc1_four"), ("bc1", "bc1"),
                      ("bc1_punch", "bc1"), ("alpha_single_mode", "bc4"),
                      ("multi_mode_ldr", "bc7"), ("bc7enc16", "bc7")):
        emitted.append((f"block_api_{name}", key, api_words[name]))
    later["native_oracle"] = phase_native_oracle(native_info, emitted)
    emit(later["native_oracle"])
    later["quality_matrix"] = phase_quality_matrix(smi, q)
    emit(later["quality_matrix"])
    later["sharded"] = phase_sharded(smi, shape_inputs[f"bc1_{side_big}"],
                                     rgba1k, q)
    emit(later["sharded"])
    if not q:
        # the throughput bench at its own, full sizes
        later["bench"] = phase_bench(smi, decode)
        emit(later["bench"])

    if args.out:
        import os
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "results.json"), "w") as f:
            json.dump({"device": smi, "kind": kind, "build": resources,
                       "build_seconds": info["seconds"], "kernels": rows,
                       "main_path": main_rows, "launches": counts,
                       "final": final, **later, "failures": FAILURES}, f,
                      indent=1)
        for lib, log in info["ptxas"].items():
            with open(os.path.join(args.out, f"{lib}.ptxas.txt"), "w") as f:
                f.write(log)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    if q:
        # a quick run checks the build and the kernels at toy sizes; it prints
        # neither the kernels line nor the final ok line of a full run
        emit({"phase": "quick_done", "quick": True, "kernels_quick": final})
        return 0
    print(smi, flush=True)
    emit({"kernels": final})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
