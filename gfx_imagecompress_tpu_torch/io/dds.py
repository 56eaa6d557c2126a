"""DDS container read/write (DX10 header).

The C++ library delegates DDS IO to gfx_imageio (outside its tree; its tests
save every input/output to artifacts/*.dds, tests/test_imagecompress.cpp:9-12).
This is a minimal implementation on numpy and struct alone: enough to
round-trip every block format (BC1-BC7 + uncompressed RGBA8 / RGBA16F /
RGBA32F) using the DX10 extended header. Same bytes as the JAX package's
``io/dds.py``, over this package's containers.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..formats import BlockFormat, BLOCK_FORMAT_INFO, block_count
from ..image import CompressedImage, DeviceLike, Image, words_from_numpy

DDS_MAGIC = 0x20534444  # 'DDS '

# header flags
DDSD_CAPS = 0x1
DDSD_HEIGHT = 0x2
DDSD_WIDTH = 0x4
DDSD_PIXELFORMAT = 0x1000
DDSD_LINEARSIZE = 0x80000
DDSD_PITCH = 0x8
DDPF_FOURCC = 0x4
FOURCC_DX10 = 0x30315844  # 'DX10'

# DXGI_FORMAT values
DXGI = {
    BlockFormat.BC1_UNORM: 71, BlockFormat.BC1_SRGB: 72,
    BlockFormat.BC2_UNORM: 74, BlockFormat.BC2_SRGB: 75,
    BlockFormat.BC3_UNORM: 77, BlockFormat.BC3_SRGB: 78,
    BlockFormat.BC4_UNORM: 80, BlockFormat.BC4_SNORM: 81,
    BlockFormat.BC5_UNORM: 83, BlockFormat.BC5_SNORM: 84,
    BlockFormat.BC6H_UFLOAT: 95, BlockFormat.BC6H_SFLOAT: 96,
    BlockFormat.BC7_UNORM: 98, BlockFormat.BC7_SRGB: 99,
}
DXGI_INV = {v: k for k, v in DXGI.items()}
DXGI_RGBA8 = 28
DXGI_RGBA8_SRGB = 29
DXGI_RGBA16F = 10
DXGI_RGBA32F = 2
RESOURCE_DIMENSION_TEXTURE2D = 3


def _header(width: int, height: int, dxgi_format: int, array_size: int,
            linear_size: int) -> bytes:
    h = struct.pack("<I", DDS_MAGIC)
    flags = (DDSD_CAPS | DDSD_HEIGHT | DDSD_WIDTH | DDSD_PIXELFORMAT
             | DDSD_LINEARSIZE)
    h += struct.pack("<7I", 124, flags, height, width, linear_size, 1, 1)
    h += b"\x00" * 44  # reserved1[11]
    # DDS_PIXELFORMAT: size, flags, fourCC, rgb bit stuff (zeros)
    h += struct.pack("<4I", 32, DDPF_FOURCC, FOURCC_DX10, 0)
    h += struct.pack("<4I", 0, 0, 0, 0)
    h += struct.pack("<5I", 0x1000, 0, 0, 0, 0)  # caps = DDSCAPS_TEXTURE
    # DX10 header
    h += struct.pack("<5I", dxgi_format, RESOURCE_DIMENSION_TEXTURE2D, 0,
                     array_size, 0)
    return h


def write_compressed(path: str, img: CompressedImage) -> None:
    data = img.tobytes()
    by = block_count(img.height)
    bx = block_count(img.width)
    bpb = BLOCK_FORMAT_INFO[img.format].bytes_per_block
    linear = by * bx * bpb
    with open(path, "wb") as f:
        f.write(_header(img.width, img.height, DXGI[img.format],
                        img.slices, linear))
        f.write(data)


def write_image(path: str, img: Image, dtype: str = "rgba8") -> None:
    """Write an uncompressed source image (test-artifact parity with the
    C++ tests' SAVE_DDS of inputs)."""
    arr = img.data.detach().cpu().numpy()
    if dtype == "rgba8":
        data = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
        fmt = DXGI_RGBA8_SRGB if img.srgb else DXGI_RGBA8
        pitch = img.width * 4
    elif dtype == "rgba16f":
        data = arr.astype(np.float16)
        fmt = DXGI_RGBA16F
        pitch = img.width * 8
    elif dtype == "rgba32f":
        data = arr.astype(np.float32)
        fmt = DXGI_RGBA32F
        pitch = img.width * 16
    else:
        raise ValueError(dtype)
    if data.shape[-1] != 4:  # pad channels to 4
        pad = np.ones(data.shape[:-1] + (4 - data.shape[-1],), data.dtype)
        if data.dtype == np.uint8:
            pad *= 255
        data = np.concatenate([data, pad], axis=-1)
    with open(path, "wb") as f:
        f.write(_header(img.width, img.height, fmt, img.slices,
                        pitch * img.height))
        f.write(data.tobytes())


@dataclass
class DDSFile:
    width: int
    height: int
    array_size: int
    dxgi_format: int
    data: bytes

    @property
    def block_format(self) -> BlockFormat | None:
        return DXGI_INV.get(self.dxgi_format)


def read(path: str) -> DDSFile:
    with open(path, "rb") as f:
        raw = f.read()
    magic, size, flags, height, width = struct.unpack_from("<5I", raw, 0)
    if magic != DDS_MAGIC or size != 124:
        raise ValueError(f"{path}: not a DDS file")
    pf_flags, fourcc = struct.unpack_from("<II", raw, 80)  # ddspf.dwFlags/.dwFourCC
    offset = 4 + 124
    array_size = 1
    if pf_flags & DDPF_FOURCC and fourcc == FOURCC_DX10:
        dxgi_format, _, _, array_size, _ = struct.unpack_from(
            "<5I", raw, offset)
        offset += 20
    elif pf_flags & DDPF_FOURCC:
        legacy = {0x31545844: 71,   # 'DXT1' -> BC1
                  0x33545844: 74,   # 'DXT3' -> BC2
                  0x35545844: 77,   # 'DXT5' -> BC3
                  0x55344342: 80,   # 'BC4U'
                  0x55354342: 83}   # 'BC5U'
        if fourcc not in legacy:
            raise ValueError(f"{path}: unsupported FourCC {fourcc:#x}")
        dxgi_format = legacy[fourcc]
    else:
        raise ValueError(f"{path}: uncompressed legacy DDS not supported")
    return DDSFile(width=width, height=height, array_size=array_size,
                   dxgi_format=dxgi_format, data=raw[offset:])


def read_compressed(path: str, device: DeviceLike = None) -> CompressedImage:
    """Read a block-compressed DDS; the blocks are placed on ``device``."""
    dds = read(path)
    fmt = dds.block_format
    if fmt is None:
        raise ValueError(f"{path}: DXGI format {dds.dxgi_format} is not a "
                         "supported block format")
    info = BLOCK_FORMAT_INFO[fmt]
    by, bx = block_count(dds.height), block_count(dds.width)
    n = dds.array_size * by * bx * info.words_per_block
    words = np.frombuffer(dds.data, dtype="<u4", count=n)
    grid = words.reshape(dds.array_size, by, bx, info.words_per_block)
    return CompressedImage(blocks=words_from_numpy(grid, device), format=fmt,
                           width=dds.width,
                           height=dds.height, slices=dds.array_size)
