"""Lowest-level block compression API (batched).

The block entry points of the C++ library (imagecompress.h:103-142), one
call for ``(N, ...)`` blocks instead of one 4x4 block: each takes an array or
a tensor of normalised floats in [0, 1] (imagecompress.h:104-105; the
bc7enc16 entry takes packed RGBA8 words) and returns ``(N, 2)`` or
``(N, 4)`` int32 words, the bit patterns of the block's little-endian uint32
words, on the device it ran on.

``device=None`` means CUDA (``image.resolve_device``): the entries call the
port's kernel wrappers on a CUDA tensor, which launch the hand-written
kernels, and on ``device="cpu"`` the same wrappers run the plain versions.
The explicit-alpha entry has no kernel: its quantization is elementwise
integer arithmetic in torch on either device.

The mapping follows the JAX package's ``blockapi``:
- the two colour entries take ``iters = 2 + refinement_steps`` and one
  refinement pass, with ``b3d_refinement`` as the joint 3-channel cube
  (``b3d``); ``adaptive_colour_weights`` is accepted and ignored, as there;
- ``compress_multi_mode_ldr_blocks`` accepts ``src_has_alpha`` and does not
  use it, as there.
"""
from __future__ import annotations

import numpy as np
import torch

from .image import DeviceLike, resolve_device
from .kernels import bc1 as _bc1
from .kernels import bc4 as _bc4
from .kernels.bc7_est import div_scalar
from .options import PERCEPTUAL_WEIGHTS

F32 = torch.float32


def _floats(x, device: DeviceLike, ndim: int) -> torch.Tensor:
    """An array or tensor -> a contiguous float32 tensor on the device."""
    dev = resolve_device(device)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(x, np.float32)))
    t = t.to(device=dev, dtype=F32).contiguous()
    if t.ndim != ndim or t.shape[1] != 16:
        want = "(N,16)" if ndim == 2 else "(N,16,C)"
        raise ValueError(f"expected {want} blocks, got {tuple(t.shape)}")
    return t


def _colour_words(blocks, refinement_steps, b3d_refinement, **kw):
    words, _ = _bc1.encode_bc1_blocks(
        blocks, weights=PERCEPTUAL_WEIGHTS, iters=2 + int(refinement_steps),
        passes=1, b3d=bool(b3d_refinement), **kw)
    return words


def compress_rgb_single_mode_blocks(rgb, adaptive_colour_weights=False,
                                    b3d_refinement=False,
                                    refinement_steps=1,
                                    device: DeviceLike = None):
    """Image_CompressAMDRGBSingleModeBlock analog (imagecompress.h:111-115):
    (N,16,3) float RGB -> (N,2) BC2/BC3-style colour block (four colours
    only)."""
    return _colour_words(_floats(rgb, device, 3), refinement_steps,
                         b3d_refinement, allow_three=False)


def compress_alpha_single_mode_blocks(alpha, device: DeviceLike = None):
    """Image_CompressAMDAlphaSingleModeBlock analog (imagecompress.h:117):
    (N,16) float A -> (N,2) interpolated-alpha block."""
    words, _ = _bc4.encode_bc4_blocks(_floats(alpha, device, 2))
    return words


def compress_explicit_alpha_blocks(alpha, device: DeviceLike = None):
    """Image_CompressAMDExplictAlphaSingleModeBlock analog
    (imagecompress.h:119): (N,16) float A -> (N,2) 4-bit alpha."""
    words, _ = _bc4.encode_bc2_alpha_blocks(_floats(alpha, device, 2))
    return words


def compress_bc1_blocks(rgba, adaptive_colour_weights=False,
                        b3d_refinement=False, refinement_steps=1,
                        alpha_threshold=0.0, device: DeviceLike = None):
    """Image_CompressAMDBC1Block analog (imagecompress.h:122-127):
    (N,16,4) float RGBA -> (N,2) BC1 block; threshold in 0..1, <= 0
    disables punch-through."""
    return _colour_words(_floats(rgba, device, 3), refinement_steps,
                         b3d_refinement, allow_three=True,
                         use_alpha=alpha_threshold > 0.0,
                         alpha_threshold=max(alpha_threshold, 0.0))


def compress_multi_mode_ldr_blocks(rgba, mode_mask=0xFF, src_has_alpha=True,
                                   quality=1.0, colour_restrict=True,
                                   alpha_restrict=True, performance=1.0,
                                   device: DeviceLike = None):
    """Image_CompressAMDMultiModeLDRBlock analog (imagecompress.h:129-136):
    (N,16,4) float RGBA -> (N,4) BC7 block (full mode search)."""
    from .kernels.bc7_full import encode_bc7_blocks
    words, _ = encode_bc7_blocks(
        _floats(rgba, device, 3), quality=quality, mode_mask=mode_mask,
        colour_restrict=colour_restrict, alpha_restrict=alpha_restrict,
        performance=performance)
    return words


def compress_richgel999_bc7enc16_blocks(rgba8, fast=False, perceptual=True,
                                        device: DeviceLike = None):
    """Image_CompressRichGel999BC7enc16 analog (imagecompress.h:139-142):
    (N,16) packed RGBA8 words (R in the low byte; uint32, or their int32 bit
    patterns) -> (N,4) BC7 block (modes 1/6)."""
    from .kernels.bc7_fast import encode_bc7_fast_blocks
    dev = resolve_device(device)
    if isinstance(rgba8, torch.Tensor):
        v = rgba8.to(device=dev, dtype=torch.int64)
    else:
        v = torch.from_numpy(np.asarray(rgba8).astype(np.int64)).to(dev)
    if v.ndim != 2 or v.shape[1] != 16:
        raise ValueError(f"expected (N,16) packed words, got {tuple(v.shape)}")
    rgba = torch.stack([(v >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1)
    # a float32 division, as the kernels' plain versions divide
    # (div_scalar); XLA on the CPU would multiply by 1/255 (ROADMAP Queue 3)
    x = div_scalar(rgba.to(F32), 255.0).contiguous()
    words, _ = encode_bc7_fast_blocks(x, fast=fast, perceptual=perceptual)
    return words
