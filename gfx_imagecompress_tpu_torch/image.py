"""Image containers over torch tensors.

``Image`` holds pixel data as a dense ``(slices, H, W, C)`` float32 tensor;
LDR data is normalised to [0, 1] (the block API contract of the C++ library,
imagecompress.h:104-105), HDR data is float32 read as half-precision range.

``CompressedImage`` holds the packed block stream as a ``(slices, BY, BX, W)``
tensor of 32-bit words plus the logical (pre-rounding) dimensions; the C++
library rounds stored dimensions up to block multiples
(tests/test_imagecompress.cpp:146-165 asserts 257 -> 260), and both are kept.

**Word dtype.** Packed words are ``torch.int32`` tensors that hold the bit
pattern of the block's little-endian uint32 words: torch has no shift, or and
compare for ``uint32`` on the CPU, so ``int32`` is the storage type everywhere
in this package. The CUDA kernels write ``uint32_t`` into that storage; the
plain versions pack in ``int64`` and wrap to ``int32`` at the end (bit 31 is
set by BC4's index field); the decoders widen to non-negative ``int64`` before
they shift. ``tobytes`` and ``convert.compressed_to_numpy`` reinterpret the
storage as ``<u4``.

Every entry point takes an explicit ``device``; ``None`` means ``"cuda"``, and
where no CUDA device exists that raises instead of carrying on on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from .formats import BlockFormat, block_count

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device that does not exist raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 word storage -> little-endian ``<u4`` numpy array, same shape."""
    if words.dtype != torch.int32:
        raise TypeError(f"packed words are int32, got {words.dtype}")
    arr = words.detach().cpu().contiguous().numpy()
    return arr.view(np.uint32).astype("<u4", copy=False)


def words_from_numpy(arr, device: DeviceLike = None) -> torch.Tensor:
    """uint32 (or int32 bit-pattern) numpy words -> int32 word storage."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.kind not in "iu" or a.dtype.itemsize != 4:
        raise TypeError(f"expected 32-bit integer words, got {a.dtype}")
    a = a.astype(a.dtype.newbyteorder("="), copy=False).view(np.int32)
    return torch.from_numpy(a.copy()).to(resolve_device(device))


@dataclass(frozen=True)
class Image:
    """Uncompressed image: data (slices, H, W, C) float32."""

    data: torch.Tensor
    srgb: bool = False
    signed: bool = False  # SNORM / signed half source
    hdr: bool = False     # float source (BC6H-eligible)

    @property
    def slices(self) -> int:
        return self.data.shape[0]

    @property
    def height(self) -> int:
        return self.data.shape[1]

    @property
    def width(self) -> int:
        return self.data.shape[2]

    @property
    def channels(self) -> int:
        return self.data.shape[3]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def from_array(arr, srgb: bool = False, signed: bool = False,
                   hdr: bool = False, device: DeviceLike = None) -> "Image":
        """Accepts (H,W,C) or (S,H,W,C), numpy or torch; uint8 arrays are
        normalised to [0,1]. The data is placed on ``device``."""
        dev = resolve_device(device)
        a = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.array(arr))                      # a copy the tensor may own
        a = a.to(dev)
        if a.ndim == 3:
            a = a[None]
        if a.ndim != 4:
            raise ValueError(
                f"expected (H,W,C) or (S,H,W,C), got {tuple(a.shape)}")
        if a.dtype == torch.uint8:
            a = a.to(torch.float32) / 255.0
        elif a.dtype != torch.float32:
            a = a.to(torch.float32)
        return Image(data=a, srgb=srgb, signed=signed, hdr=hdr)


@dataclass(frozen=True)
class CompressedImage:
    """Block-compressed image.

    ``blocks``: (S, BY, BX, W) int32 word storage (see the module docstring)
    with W = 2 for 8-byte formats and 4 for 16-byte formats, little-endian
    word order (word 0 = lowest 4 bytes of the 64/128-bit block, matching the
    C++ library's uint32* writes, amd_bcx_helpers.cpp:98-104).
    """

    blocks: torch.Tensor
    format: BlockFormat
    width: int   # logical source width (pre round-up)
    height: int
    slices: int = 1

    @property
    def stored_width(self) -> int:
        """Stored dims are rounded up to block multiples (bc1:33-35)."""
        return block_count(self.width) * 4

    @property
    def stored_height(self) -> int:
        return block_count(self.height) * 4

    @property
    def blocks_x(self) -> int:
        return block_count(self.width)

    @property
    def blocks_y(self) -> int:
        return block_count(self.height)

    def tobytes(self) -> bytes:
        """Serialize the block stream in DDS scan order (little-endian)."""
        return words_to_numpy(self.blocks).tobytes()
