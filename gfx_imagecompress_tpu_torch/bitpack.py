"""Bit-field extraction over packed 32-bit words.

Every block is W little-endian 32-bit words and every field read is a
static-offset shift/mask over the whole ``(N, W)`` batch.

Bit addressing: bit ``b`` of the 64/128-bit block lives in word ``b // 32``
at in-word position ``b % 32`` (little-endian, matching the C++ library's
``uint32*`` stores and the DDS on-disk layout).

Words arrive as int32 storage (see ``image.py``); they are widened to
non-negative int64 before any shift, so bit 31 never acts as a sign.
Only the readers the BC1-BC5 decoders use live here; the field writers
(``field_or``, ``Sink``) come with the BC7/BC6H packers.
"""
from __future__ import annotations

import torch


def mask(nbits: int) -> int:
    return (1 << nbits) - 1


def _u32(col: torch.Tensor) -> torch.Tensor:
    """One word column -> int64 holding its unsigned 32-bit value."""
    return col.to(torch.int64) & 0xFFFFFFFF


def extract(words: torch.Tensor, start: int, nbits: int) -> torch.Tensor:
    """Read an ``nbits``-wide field at static offset from (N, W) words ->
    (N,) int64, non-negative."""
    assert 0 < nbits <= 32
    w, off = divmod(start, 32)
    v = _u32(words[:, w]) >> off
    if off + nbits > 32:
        v = v | (_u32(words[:, w + 1]) << (32 - off))
    return v & mask(nbits)


def extract_indices(words: torch.Tensor, start: int,
                    bits_per_index: int) -> torch.Tensor:
    """(N, 16) int64 per-pixel indices packed LSB-first from ``start``."""
    cols = [extract(words, start + i * bits_per_index, bits_per_index)
            for i in range(16)]
    return torch.stack(cols, dim=1)
