"""Public API: per-format image compressors, dispatcher, codec picker.

The counterpart of the C++ library's
  - ImageCompress_Compress / ImageCompress_PickCompressionType
    (imagecompress.cpp:20-116)
  - Image_CompressAMDBC1..BC5 (amd_bc{1..5}_compressor.cpp)
and of the JAX package's ``api.py``, whose option plumbing it mirrors exactly.

Each compressor is image -> block tensor -> one batched encode -> packed word
grid, on the device the image lives on: a CUDA image goes through the CUDA
kernels, a CPU image through their plain PyTorch versions. There is no
init/deinit: ramps are recomputed inside the search.

Progress callbacks: an encode is one launch, so the C++ library's per-row
progress/cancel hook (imagecompress.h:5) maps to ``compress_chunked``, which
fires the callback between row bands and honours cancellation between (not
within) launches.

BC7 is ported in both forms: the full multi-mode search (``compress_amd_bc7``)
and the fast path (modes 1 + 6, ``compress_richgel999_bc7``); BC6H, signed and
unsigned, is ``compress_amd_bc6h``.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch

from .formats import BlockFormat, CompressType, PickFlags
from .image import CompressedImage, Image
from .kernels.bc1 import (encode_bc1_blocks, encode_bc2_blocks,
                          encode_bc3_blocks)
from .kernels.bc4 import encode_bc4_blocks, encode_bc5_blocks
from .kernels.bc6h import encode_bc6h_blocks
from .kernels.bc7_fast import encode_bc7_fast_blocks
from .kernels.bc7_full import encode_bc7_blocks
from .options import (AMDBackendOptions, BC1Options, BC6HOptions, BC7Options,
                      PERCEPTUAL_WEIGHTS, RichGel999Options)
from .pipeline.blocks import image_to_blocks, packed_to_grid
from .pipeline.chunking import encode_chunked

ProgressFunc = Callable[[float], bool]  # returns True to cancel


def _grid(img: Image, words, wpb: int):
    return packed_to_grid(words, img.slices, img.height, img.width, wpb)


def compress_amd_bc1(src: Image,
                     amd_options: Optional[AMDBackendOptions] = None,
                     options: Optional[BC1Options] = None) -> CompressedImage:
    """Image_CompressAMDBC1 analog (amd_bc1_compressor.cpp:11-101)."""
    amd = amd_options or AMDBackendOptions()
    opt = options or BC1Options()
    blocks = image_to_blocks(src.data)
    use_alpha = opt.use_alpha and src.channels >= 4
    words, _ = encode_bc1_blocks(
        blocks, weights=PERCEPTUAL_WEIGHTS,
        iters=2 + amd.refinement_steps,
        b3d=amd.b3d_refinement,
        use_alpha=use_alpha,
        alpha_threshold=float(opt.alpha_threshold) / 255.0,
        adaptive=amd.adaptive_colour_weights)
    fmt = BlockFormat.BC1_SRGB if src.srgb else BlockFormat.BC1_UNORM
    return CompressedImage(_grid(src, words, 2), fmt, src.width, src.height,
                           src.slices)


def compress_amd_bc2(src: Image,
                     amd_options: Optional[AMDBackendOptions] = None
                     ) -> CompressedImage:
    """Image_CompressAMDBC2 analog: explicit 4-bit alpha + RGB block in one
    launch (amd_bc2_compressor.cpp:41-46)."""
    amd = amd_options or AMDBackendOptions()
    blocks = image_to_blocks(src.data)
    words, _ = encode_bc2_blocks(
        _rgba(blocks), weights=PERCEPTUAL_WEIGHTS,
        iters=2 + amd.refinement_steps,
        passes=2 if amd.b3d_refinement else 1,
        adaptive=amd.adaptive_colour_weights)
    fmt = BlockFormat.BC2_SRGB if src.srgb else BlockFormat.BC2_UNORM
    return CompressedImage(_grid(src, words, 4), fmt, src.width, src.height,
                           src.slices)


def compress_amd_bc3(src: Image,
                     amd_options: Optional[AMDBackendOptions] = None
                     ) -> CompressedImage:
    """Image_CompressAMDBC3 analog: interpolated alpha + RGB block in one
    launch (amd_bc3_compressor.cpp:41-46)."""
    amd = amd_options or AMDBackendOptions()
    blocks = image_to_blocks(src.data)
    words, _ = encode_bc3_blocks(
        _rgba(blocks), weights=PERCEPTUAL_WEIGHTS,
        iters=2 + amd.refinement_steps,
        passes=2 if amd.b3d_refinement else 1,
        adaptive=amd.adaptive_colour_weights)
    fmt = BlockFormat.BC3_SRGB if src.srgb else BlockFormat.BC3_UNORM
    return CompressedImage(_grid(src, words, 4), fmt, src.width, src.height,
                           src.slices)


def compress_amd_bc4(src: Image) -> CompressedImage:
    """Image_CompressAMDBC4 analog.

    NOTE: the C++ library samples channel 1 (G) due to a bug
    (amd_bc4_compressor.cpp:34-37); like the JAX package this samples
    channel 0 (R) per the BC4 format contract.
    """
    blocks = image_to_blocks(src.data)
    words, _ = encode_bc4_blocks(blocks[:, :, 0].contiguous())
    fmt = BlockFormat.BC4_SNORM if src.signed else BlockFormat.BC4_UNORM
    return CompressedImage(_grid(src, words, 2), fmt, src.width, src.height,
                           src.slices)


def compress_amd_bc5(src: Image) -> CompressedImage:
    """Image_CompressAMDBC5 analog: channels 0,1 -> two scalar blocks in
    one launch (amd_bc5_compressor.cpp:35-41)."""
    blocks = image_to_blocks(src.data)
    words, _ = encode_bc5_blocks(blocks)
    fmt = BlockFormat.BC5_SNORM if src.signed else BlockFormat.BC5_UNORM
    return CompressedImage(_grid(src, words, 4), fmt, src.width, src.height,
                           src.slices)


def compress_amd_bc6h(src: Image,
                      amd_options: Optional[AMDBackendOptions] = None,
                      options: Optional[BC6HOptions] = None
                      ) -> CompressedImage:
    """Image_CompressAMDBC6H analog (amd_bc6h_compressor.cpp:10-90): the half
    conversion and one search launch over all blocks; ``src.signed`` picks
    BC6H_SFLOAT over BC6H_UFLOAT.

    The reference has an argument-order bug that drops the mode mask
    (amd_bc6h_compressor.cpp:28 / amd_bc6h_body.hpp:303); here the mask is
    honoured. ``options`` carries the BC6H quality and the full 16-bit mode
    mask; without it, ``amd_options`` gives its (8-bit in the reference)
    mode mask at quality 1.0; without either, quality 1.0 and all modes.
    """
    if options is not None:
        quality, mask = options.quality, options.mode_mask
    elif amd_options is not None:
        quality, mask = 1.0, amd_options.mode_mask
    else:
        quality, mask = 1.0, 0xFFFF
    blocks = image_to_blocks(src.data)
    words, _ = encode_bc6h_blocks(
        blocks[:, :, :3].contiguous(), signed=src.signed, mode_mask=mask,
        quality=quality)
    fmt = (BlockFormat.BC6H_SFLOAT if src.signed
           else BlockFormat.BC6H_UFLOAT)
    return CompressedImage(_grid(src, words, 4), fmt, src.width, src.height,
                           src.slices)


def compress_amd_bc7(src: Image,
                     amd_options: Optional[AMDBackendOptions] = None,
                     bc7_options: Optional[BC7Options] = None
                     ) -> CompressedImage:
    """Image_CompressAMDBC7 analog (amd_bc7_compressor.cpp:25-112): the full
    multi-mode search, quality 1.0 by default, in chunks of 65,536 blocks;
    per chunk the partition shortlists and one search launch per enabled
    mode. Without ``bc7_options`` the AMD options' ``mode_mask`` applies."""
    amd = amd_options or AMDBackendOptions()
    opt = bc7_options or BC7Options(mode_mask=amd.mode_mask)
    blocks = image_to_blocks(src.data)
    words, _ = encode_chunked(
        partial(encode_bc7_blocks, quality=opt.quality,
                mode_mask=opt.mode_mask,
                colour_restrict=opt.colour_restrict,
                alpha_restrict=opt.alpha_restrict,
                performance=opt.performance),
        _rgba(blocks), chunk=65536)
    fmt = BlockFormat.BC7_SRGB if src.srgb else BlockFormat.BC7_UNORM
    return CompressedImage(_grid(src, words, 4), fmt, src.width, src.height,
                           src.slices)


def compress_richgel999_bc7(src: Image,
                            options: Optional[RichGel999Options] = None
                            ) -> CompressedImage:
    """Image_CompressRichGel999BC7 analog (richgel999_bc7enc16.cpp:21-71):
    fast BC7 restricted to modes 1 and 6; the partition shortlist and the
    search are one launch each."""
    opt = options or RichGel999Options()
    blocks = image_to_blocks(src.data)
    words, _ = encode_bc7_fast_blocks(
        _rgba(blocks), fast=opt.fast, perceptual=opt.perceptual)
    fmt = BlockFormat.BC7_SRGB if src.srgb else BlockFormat.BC7_UNORM
    return CompressedImage(_grid(src, words, 4), fmt, src.width, src.height,
                           src.slices)


def compress(ctype: CompressType, src: Image,
             fast: bool = False) -> Optional[CompressedImage]:
    """ImageCompress_Compress analog (imagecompress.cpp:20-50).

    ``fast`` selects the bc7enc16-style path for BC7. Unimplemented codecs
    (ETC/ASTC - stubs in the C++ library too, imagecompress.cpp:40-44) return
    None.
    """
    if ctype == CompressType.DXBC1:
        return compress_amd_bc1(src)
    if ctype == CompressType.DXBC2:
        return compress_amd_bc2(src)
    if ctype == CompressType.DXBC3:
        return compress_amd_bc3(src)
    if ctype == CompressType.DXBC4:
        return compress_amd_bc4(src)
    if ctype == CompressType.DXBC5:
        return compress_amd_bc5(src)
    if ctype == CompressType.DXBC6H:
        return compress_amd_bc6h(src)
    if ctype == CompressType.DXBC7:
        if fast:
            return compress_richgel999_bc7(src)
        return compress_amd_bc7(src)
    return None


def pick_compression_type(flags: PickFlags, src: Image) -> CompressType:
    """ImageCompress_PickCompressionType analog - pure policy
    (imagecompress.cpp:52-116): float sources -> BC6H; 1 channel -> BC4;
    2 -> BC5; RGB(A) -> BC7 if allowed, else ASTC, else BC3/BC1 by alpha."""
    if src.hdr:
        if flags & PickFlags.ALLOW_DXBC6AND7:
            return CompressType.DXBC6H
        return CompressType.NONE
    ch = src.channels
    if ch == 1:
        if flags & PickFlags.ALLOW_DXBC1TO5:
            return CompressType.DXBC4
        return CompressType.NONE
    if ch == 2:
        if flags & PickFlags.ALLOW_DXBC1TO5:
            return CompressType.DXBC5
        return CompressType.NONE
    if flags & PickFlags.ALLOW_DXBC6AND7:
        return CompressType.DXBC7
    if flags & PickFlags.ALLOW_ASTC:
        return CompressType.ASTC
    if flags & PickFlags.ALLOW_DXBC1TO5:
        if ch == 4:
            return CompressType.DXBC3
        return CompressType.DXBC1
    return CompressType.NONE


def compress_chunked(ctype: CompressType, src: Image,
                     progress: Optional[ProgressFunc] = None,
                     rows_per_chunk: int = 64,
                     fast: bool = False) -> Optional[CompressedImage]:
    """Progress-callback variant: encodes row bands of blocks and fires
    ``progress(percent)`` between launches; returning True cancels and
    yields None (the C++ cancellation contract,
    amd_bc1_compressor.cpp:64-68)."""
    h = src.height
    chunks = []
    for y0 in range(0, h, rows_per_chunk):
        y1 = min(y0 + rows_per_chunk, h)
        band = Image(data=src.data[:, y0:y1], srgb=src.srgb,
                     signed=src.signed, hdr=src.hdr)
        out = compress(ctype, band, fast=fast)
        if out is None:
            return None
        chunks.append(out)
        if progress is not None and progress(100.0 * y1 / h):
            return None
    blocks = torch.cat([c.blocks for c in chunks], dim=1)
    return CompressedImage(blocks, chunks[0].format, src.width, src.height,
                           src.slices)


def _rgba(blocks):
    """(N,16,C) -> contiguous (N,16,4); a missing alpha reads as opaque."""
    if blocks.shape[-1] >= 4:
        return blocks[:, :, :4].contiguous()
    pad = torch.ones_like(blocks[:, :, :1])
    return torch.cat([blocks[:, :, :3], pad], dim=-1)
