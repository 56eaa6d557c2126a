"""Image <-> block-tensor layout.

Replaces the C++ library's per-block gather/scatter loop (block_utils.cpp:7-160
``ReadNxNBlock*``/``WriteNxNBlock``, called from the per-format compressors'
triple loop, amd_bc1_compressor.cpp:44-70) by ONE edge-clamp pad plus a
reshape/permute that yields a dense ``(N, 16, C)`` block tensor which every
encoder consumes batched. Edge-clamp replication for images that are not
multiples of 4 matches ReadNxNBlockF's ``Math_ClampI(...)`` gather
(block_utils.cpp:17-24): clamping the sample coordinate to the last
row/column is exactly an index clamp.

The block axis N = S*BY*BX is the parallel axis: on the card one CUDA thread
encodes one block. Blocks never read their neighbours.
"""
from __future__ import annotations

import torch

from ..formats import block_count


def pad_to_blocks(img: torch.Tensor) -> torch.Tensor:
    """Edge-clamp pad (S,H,W,C) so H and W are multiples of 4."""
    s, h, w, c = img.shape
    ph = block_count(h) * 4 - h
    pw = block_count(w) * 4 - w
    if ph == 0 and pw == 0:
        return img
    # index clamp: works for every dtype and for pads wider than the image
    ys = torch.arange(h + ph, device=img.device).clamp_(max=h - 1)
    xs = torch.arange(w + pw, device=img.device).clamp_(max=w - 1)
    return img.index_select(1, ys).index_select(2, xs)


def image_to_blocks(img: torch.Tensor) -> torch.Tensor:
    """(S, H, W, C) -> (N, 16, C) with N = S*BY*BX, raster block order.

    Pixel order within a block is row-major (y*4+x), matching the C++ block
    layout (block_utils.cpp:17-24: ``block[(y * blockWidth) + x]``). The
    result is contiguous.
    """
    img = pad_to_blocks(img)
    s, h, w, c = img.shape
    by, bx = h // 4, w // 4
    t = img.reshape(s, by, 4, bx, 4, c)
    t = t.permute(0, 1, 3, 2, 4, 5)          # (S, BY, BX, 4, 4, C)
    return t.reshape(s * by * bx, 16, c)


def blocks_to_image(blocks: torch.Tensor, slices: int, height: int,
                    width: int) -> torch.Tensor:
    """(N, 16, C) -> (S, H, W, C), cropping any block-padding rows/cols."""
    c = blocks.shape[2]
    by, bx = block_count(height), block_count(width)
    t = blocks.reshape(slices, by, bx, 4, 4, c)
    t = t.permute(0, 1, 3, 2, 4, 5)          # (S, BY, 4, BX, 4, C)
    t = t.reshape(slices, by * 4, bx * 4, c)
    return t[:, :height, :width, :]


def packed_to_grid(words: torch.Tensor, slices: int, height: int, width: int,
                   words_per_block: int) -> torch.Tensor:
    """(N, W) packed blocks -> (S, BY, BX, W) storage grid."""
    by, bx = block_count(height), block_count(width)
    return words.reshape(slices, by, bx, words_per_block)


def grid_to_packed(grid: torch.Tensor) -> torch.Tensor:
    """(S, BY, BX, W) -> (N, W)."""
    s, by, bx, w = grid.shape
    return grid.reshape(s * by * bx, w)
