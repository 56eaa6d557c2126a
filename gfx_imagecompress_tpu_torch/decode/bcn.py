"""Bit-exact BC1-BC5 block decoders (batched, integer math only).

The C++ library ships NO decoder (its tests assert only metadata); these
decoders are the round-trip oracle. All arithmetic is integer, so results are
bit-exact on every device and equal to the JAX package's ``decode/bcn.py``.

Decode conventions (BC1/BC4 interpolation precision is implementation-defined
within D3D tolerances):
  - 565 endpoint expansion by bit replication: r8 = (r5<<3)|(r5>>2),
    g8 = (g6<<2)|(g6>>4) - the C++ clusterizer's expansion
    (amd_bcx_body.cpp:157-181 MkWkRmpPts).
  - BC1 thirds are rounded to nearest: p2 = (2*a + b + 1) // 3.
  - BC4 sevenths/fifths rounded to nearest: (x*a0 + y*a1 + 3) // 7,
    (x*a0 + y*a1 + 2) // 5.
The encoders use the *same* integer palettes for their error models, so
encode-side error == decode-side error exactly.

Decoded pixels are int32 in [0, 255].
"""
from __future__ import annotations

import torch

from .. import bitpack

I32 = torch.int32


def expand_565(c: torch.Tensor):
    """(N,) 565 words -> three (N,) 8-bit channels (r, g, b)."""
    r5 = (c >> 11) & 0x1F
    g6 = (c >> 5) & 0x3F
    b5 = c & 0x1F
    r = (r5 << 3) | (r5 >> 2)
    g = (g6 << 2) | (g6 >> 4)
    b = (b5 << 3) | (b5 >> 2)
    return r, g, b


def bc1_palette(c0: torch.Tensor, c1: torch.Tensor, force_four: bool):
    """Build (N, 4, 4) RGBA palettes from 565 endpoint words.

    ``force_four``: BC2/BC3 colour blocks always decode in 4-colour mode
    regardless of endpoint order (D3D spec); plain BC1 uses c0 > c1 to select
    4-colour vs 3-colour + transparent.
    """
    e0 = torch.stack(expand_565(c0), dim=-1)  # (N, 3)
    e1 = torch.stack(expand_565(c1), dim=-1)
    p2_4 = (2 * e0 + e1 + 1) // 3
    p3_4 = (e0 + 2 * e1 + 1) // 3
    p2_3 = (e0 + e1 + 1) // 2
    p3_3 = torch.zeros_like(e0)
    four = (c0 > c1) | force_four
    four = four[:, None]
    p2 = torch.where(four, p2_4, p2_3)
    p3 = torch.where(four, p3_4, p3_3)
    rgb = torch.stack([e0, e1, p2, p3], dim=1)          # (N, 4, 3)
    opaque = torch.full_like(four, 255, dtype=rgb.dtype).expand(-1, 4)
    punch = torch.tensor([255, 255, 255, 0], dtype=rgb.dtype,
                         device=rgb.device)[None, :]
    alpha = torch.where(four, opaque, punch)             # (N, 4)
    return torch.cat([rgb, alpha[:, :, None]], dim=-1)


def decode_bc1(words: torch.Tensor, force_four: bool = False) -> torch.Tensor:
    """(N, 2) words -> (N, 16, 4) int32 RGBA in [0, 255]."""
    c0 = bitpack.extract(words, 0, 16)
    c1 = bitpack.extract(words, 16, 16)
    pal = bc1_palette(c0, c1, force_four)                # (N, 4, 4)
    idx = bitpack.extract_indices(words, 32, 2)          # (N, 16)
    out = torch.gather(pal, 1, idx[:, :, None].expand(-1, -1, 4))
    return out.to(I32)


def bc4_palette(a0: torch.Tensor, a1: torch.Tensor) -> torch.Tensor:
    """(N,) endpoint bytes -> (N, 8) interpolated alpha palette."""
    eight = a0 > a1
    pal = [a0, a1]
    for i in range(2, 8):
        w1 = i - 1
        p8 = ((8 - i) * a0 + w1 * a1 + 3) // 7
        if i < 6:
            p6 = ((6 - i) * a0 + w1 * a1 + 2) // 5
        else:
            p6 = torch.full_like(a0, 0 if i == 6 else 255)
        pal.append(torch.where(eight, p8, p6))
    return torch.stack(pal, dim=1)


def decode_bc4_block(words: torch.Tensor) -> torch.Tensor:
    """(N, 2) alpha-block words -> (N, 16) int32 in [0, 255]."""
    a0 = bitpack.extract(words, 0, 8)
    a1 = bitpack.extract(words, 8, 8)
    pal = bc4_palette(a0, a1)                            # (N, 8)
    idx = bitpack.extract_indices(words, 16, 3)          # (N, 16)
    return torch.gather(pal, 1, idx).to(I32)


def decode_bc2_alpha(words: torch.Tensor) -> torch.Tensor:
    """(N, 2) explicit-alpha words -> (N, 16) int32 in [0, 255]."""
    idx = bitpack.extract_indices(words, 0, 4)           # (N, 16) 4-bit
    return (idx * 17).to(I32)  # 4-bit -> 8-bit by replication (x * 0x11)


def _with_alpha(rgba: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.cat([rgba[:, :, :3], a[:, :, None]], dim=-1)


def decode_bc2(words: torch.Tensor) -> torch.Tensor:
    """(N, 4) words -> (N, 16, 4) int32 RGBA."""
    a = decode_bc2_alpha(words[:, 0:2])
    return _with_alpha(decode_bc1(words[:, 2:4], force_four=True), a)


def decode_bc3(words: torch.Tensor) -> torch.Tensor:
    """(N, 4) words -> (N, 16, 4) int32 RGBA."""
    a = decode_bc4_block(words[:, 0:2])
    return _with_alpha(decode_bc1(words[:, 2:4], force_four=True), a)


def decode_bc4(words: torch.Tensor) -> torch.Tensor:
    """(N, 2) words -> (N, 16, 1) int32."""
    return decode_bc4_block(words)[:, :, None]


def decode_bc5(words: torch.Tensor) -> torch.Tensor:
    """(N, 4) words -> (N, 16, 2) int32 (R block then G block, bc5:35-41)."""
    r = decode_bc4_block(words[:, 0:2])
    g = decode_bc4_block(words[:, 2:4])
    return torch.stack([r, g], dim=-1)
