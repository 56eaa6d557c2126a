"""Bit-exact BCn block decoders (the round-trip oracle)."""

from .bc6h import decode_bc6h
from .bc7 import decode_bc7
from .bcn import (decode_bc1, decode_bc2, decode_bc3, decode_bc4, decode_bc5)


def decode_image(compressed, force_four: bool = False):
    """Decode a CompressedImage -> (S, H, W, C) tensor on the device the
    blocks live on: int32 in 0..255 for the LDR formats, float32 (from the
    half bits) for BC6H."""
    from ..formats import BlockFormat
    from ..pipeline.blocks import blocks_to_image, grid_to_packed

    words = grid_to_packed(compressed.blocks)
    fmt = compressed.format
    if fmt in (BlockFormat.BC1_UNORM, BlockFormat.BC1_SRGB):
        px = decode_bc1(words, force_four)
    elif fmt in (BlockFormat.BC2_UNORM, BlockFormat.BC2_SRGB):
        px = decode_bc2(words)
    elif fmt in (BlockFormat.BC3_UNORM, BlockFormat.BC3_SRGB):
        px = decode_bc3(words)
    elif fmt in (BlockFormat.BC4_UNORM, BlockFormat.BC4_SNORM):
        px = decode_bc4(words)
    elif fmt in (BlockFormat.BC5_UNORM, BlockFormat.BC5_SNORM):
        px = decode_bc5(words)
    elif fmt in (BlockFormat.BC7_UNORM, BlockFormat.BC7_SRGB):
        px = decode_bc7(words)
    elif fmt in (BlockFormat.BC6H_UFLOAT, BlockFormat.BC6H_SFLOAT):
        px = decode_bc6h(words, signed=fmt == BlockFormat.BC6H_SFLOAT)
    else:
        raise ValueError(f"cannot decode {fmt}")
    return blocks_to_image(px, compressed.slices, compressed.height,
                           compressed.width)
