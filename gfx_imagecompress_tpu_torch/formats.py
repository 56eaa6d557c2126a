"""Format enums and destination-format metadata.

The public enums of the C++ library (imagecompress.h:7-33) and the
destination-format choice its per-format drivers make
(amd_bc1_compressor.cpp:33-35, amd_bc4_compressor.cpp:19,
amd_bc6h_compressor.cpp:19-22). Enum values, ``BLOCK_FORMAT_INFO`` and
``block_count`` are the same as in the JAX package's ``formats.py``; this is
the port's own copy, so that importing it pulls in no other framework.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class CompressType(enum.Enum):
    """Mirror of Image_CompressType (imagecompress.h:7-26)."""

    NONE = 0
    DXBC1 = 1
    DXBC2 = 2
    DXBC3 = 3
    DXBC4 = 4
    DXBC5 = 5
    DXBC6H = 6
    DXBC7 = 7
    # ETC / ASTC exist in the reference enum but are unimplemented stubs
    # (imagecompress.cpp:40-44 returns nullptr); kept for API parity.
    ETC_RGB = 8
    ETC2_RGB = 9
    ETC_RGBA_EXPLICIT = 10
    ETC_RGBA_INTERPOLATED = 11
    ASTC = 12


class PickFlags(enum.IntFlag):
    """Mirror of Image_CompressPickFlags (imagecompress.h:28-33)."""

    ALLOW_DXBC1TO5 = 0x1
    ALLOW_ASTC = 0x2
    ALLOW_ETC = 0x8
    ALLOW_DXBC6AND7 = 0x10


class BlockFormat(enum.Enum):
    """Destination block-compressed formats (TinyImageFormat_DXBC* analog)."""

    BC1_UNORM = "DXBC1_RGBA_UNORM"
    BC1_SRGB = "DXBC1_RGBA_SRGB"
    BC2_UNORM = "DXBC2_UNORM"
    BC2_SRGB = "DXBC2_SRGB"
    BC3_UNORM = "DXBC3_UNORM"
    BC3_SRGB = "DXBC3_SRGB"
    BC4_UNORM = "DXBC4_UNORM"
    BC4_SNORM = "DXBC4_SNORM"
    BC5_UNORM = "DXBC5_UNORM"
    BC5_SNORM = "DXBC5_SNORM"
    BC6H_UFLOAT = "DXBC6H_UFLOAT"
    BC6H_SFLOAT = "DXBC6H_SFLOAT"
    BC7_UNORM = "DXBC7_UNORM"
    BC7_SRGB = "DXBC7_SRGB"


@dataclass(frozen=True)
class BlockFormatInfo:
    bytes_per_block: int   # 8 for BC1/BC4, 16 for the rest
    words_per_block: int   # uint32 lanes per block
    channels: int          # source channels consumed


BLOCK_FORMAT_INFO: dict[BlockFormat, BlockFormatInfo] = {
    BlockFormat.BC1_UNORM: BlockFormatInfo(8, 2, 4),
    BlockFormat.BC1_SRGB: BlockFormatInfo(8, 2, 4),
    BlockFormat.BC2_UNORM: BlockFormatInfo(16, 4, 4),
    BlockFormat.BC2_SRGB: BlockFormatInfo(16, 4, 4),
    BlockFormat.BC3_UNORM: BlockFormatInfo(16, 4, 4),
    BlockFormat.BC3_SRGB: BlockFormatInfo(16, 4, 4),
    BlockFormat.BC4_UNORM: BlockFormatInfo(8, 2, 1),
    BlockFormat.BC4_SNORM: BlockFormatInfo(8, 2, 1),
    BlockFormat.BC5_UNORM: BlockFormatInfo(16, 4, 2),
    BlockFormat.BC5_SNORM: BlockFormatInfo(16, 4, 2),
    BlockFormat.BC6H_UFLOAT: BlockFormatInfo(16, 4, 3),
    BlockFormat.BC6H_SFLOAT: BlockFormatInfo(16, 4, 3),
    BlockFormat.BC7_UNORM: BlockFormatInfo(16, 4, 4),
    BlockFormat.BC7_SRGB: BlockFormatInfo(16, 4, 4),
}


def block_count(dim: int) -> int:
    """Number of 4-px blocks covering ``dim`` (reference: (dim+3)/4, bc1:41-42)."""
    return (dim + 3) // 4
