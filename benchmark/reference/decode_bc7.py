"""Frozen copy of the port's ``decode/bc7.py`` (the BC7 decoder, integer math
only), kept with the benchmark so that a later change to the program cannot
move the yardstick. Imports nothing of the program.
"""
from __future__ import annotations

import torch

from . import bitpack
from .bitpack_dyn import extract_dyn
from .tables import (BC7_MODES, WEIGHTS_BY_BITS, anchor_table,
                     partition_table)

I32 = torch.int32
I64 = torch.int64


def _dequant(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Expand a ``bits``-wide endpoint (pbit already appended) to 8 bits."""
    x = v << (8 - bits)
    return x | (x >> bits)


def interpolate(e0: torch.Tensor, e1: torch.Tensor, idx: torch.Tensor,
                index_bits: int) -> torch.Tensor:
    """Exact BC7 lerp: (e0*(64-w) + e1*w + 32) >> 6 (ints)."""
    w = torch.tensor(WEIGHTS_BY_BITS[index_bits], dtype=I64,
                     device=idx.device)[idx]
    return (e0 * (64 - w) + e1 * w + 32) >> 6


def _index_offsets(partition, subsets: int, index_bits: int, start: int,
                   second: bool = False):
    """Per-pixel (offset, width) of the packed index field, and the subset
    of each pixel. partition: (N,) int64. Anchors drop one bit."""
    dev = partition.device
    sub = torch.from_numpy(partition_table(subsets)).to(dev, I64)[partition]
    anch = torch.from_numpy(anchor_table(subsets)).to(dev, I64)[partition]
    iota = torch.arange(16, device=dev)[None, :]
    if second:
        # the second index set of modes 4/5 always anchors pixel 0
        is_anchor = (iota == 0).expand_as(sub)
    else:
        is_anchor = torch.zeros_like(sub, dtype=torch.bool)
        for s in range(subsets):
            is_anchor = is_anchor | ((iota == anch[:, s:s + 1]) & (sub == s))
    widths = index_bits - is_anchor.to(I64)
    offsets = torch.cumsum(widths, dim=1) - widths + start
    return offsets, widths, sub


def _decode_mode(words: torch.Tensor, m) -> torch.Tensor:
    """Decode all blocks as-if mode ``m`` -> (N, 16, 4) int64 RGBA."""
    n = words.shape[0]
    zeros = torch.zeros((n,), dtype=I64, device=words.device)
    pos = m.mode + 1

    def take(nbits):
        nonlocal pos
        if not nbits:
            return zeros
        v = bitpack.extract(words, pos, nbits)
        pos += nbits
        return v

    partition = take(m.partition_bits)
    rotation = take(m.rotation_bits)
    idx_mode = take(m.index_mode_bits)

    neps = 2 * m.subsets
    chans = 3 + (1 if m.alpha_bits else 0)
    raw = [[take(m.colour_bits) for _ in range(neps)] for _ in range(3)]
    if m.alpha_bits:
        raw.append([take(m.alpha_bits) for _ in range(neps)])

    if m.pbit_mode == "per_endpoint":
        pbits = [take(1) for _ in range(neps)]
    elif m.pbit_mode == "shared":
        shared = [take(1) for _ in range(m.subsets)]
        pbits = [shared[e // 2] for e in range(neps)]
    else:
        pbits = None

    # dequantized endpoints -> (N, neps, 4)
    eps = []
    for e in range(neps):
        comps = []
        for c in range(chans):
            bits = m.colour_bits if c < 3 else m.alpha_bits
            v = raw[c][e]
            if pbits is not None:
                v = (v << 1) | pbits[e]
                bits += 1
            comps.append(_dequant(v, bits))
        if chans == 3:
            comps.append(zeros + 255)
        eps.append(torch.stack(comps, dim=-1))
    eps = torch.stack(eps, dim=1)

    offs, widths, sub = _index_offsets(partition, m.subsets, m.index_bits, pos)
    idx1 = torch.stack(
        [extract_dyn(words, offs[:, i], widths[:, i]) for i in range(16)],
        dim=1)
    pos2 = pos + 16 * m.index_bits - m.subsets

    sel = (2 * sub)[:, :, None].expand(-1, -1, 4)
    e0 = torch.gather(eps, 1, sel)                                 # (N,16,4)
    e1 = torch.gather(eps, 1, sel + 1)

    if not m.index_bits2:
        return interpolate(e0, e1, idx1[:, :, None], m.index_bits)

    offs2, widths2, _ = _index_offsets(partition, 1, m.index_bits2, pos2,
                                       second=True)
    idx2 = torch.stack(
        [extract_dyn(words, offs2[:, i], widths2[:, i]) for i in range(16)],
        dim=1)
    # mode 4/5: colour uses idx1 (index_bits), alpha uses idx2 (index_bits2);
    # idx_mode == 1 swaps the two sets (mode 4 only)
    c_a = interpolate(e0[..., :3], e1[..., :3], idx1[:, :, None],
                      m.index_bits)
    a_a = interpolate(e0[..., 3], e1[..., 3], idx2, m.index_bits2)
    c_b = interpolate(e0[..., :3], e1[..., :3], idx2[:, :, None],
                      m.index_bits2)
    a_b = interpolate(e0[..., 3], e1[..., 3], idx1, m.index_bits)
    swap = (idx_mode == 1)[:, None]
    rgb = torch.where(swap[..., None], c_b, c_a)
    a = torch.where(swap, a_b, a_a)
    ch = [rgb[..., 0], rgb[..., 1], rgb[..., 2], a]
    # rotation: swap A with R/G/B (1/2/3)
    rot = rotation[:, None]
    for r, c in ((1, 0), (2, 1), (3, 2)):
        do = rot == r
        ch[c], ch[3] = (torch.where(do, ch[3], ch[c]),
                        torch.where(do, ch[c], ch[3]))
    return torch.stack(ch, dim=-1)


def block_modes(words: torch.Tensor) -> torch.Tensor:
    """(N, 4) words -> (N,) int64 mode: the index of the lowest set bit of
    the first byte; 8 for the reserved all-zero byte."""
    byte0 = bitpack.extract(words, 0, 8)
    mode = torch.full_like(byte0, 8)
    for b in range(7, -1, -1):
        mode = torch.where((byte0 & (1 << b)) != 0, b, mode)
    return mode


def decode_bc7(words: torch.Tensor) -> torch.Tensor:
    """(N, 4) int32 word storage -> (N, 16, 4) int32 RGBA in [0, 255]."""
    mode = block_modes(words)
    out = torch.zeros((words.shape[0], 16, 4), dtype=I64,
                      device=words.device)
    for m in BC7_MODES:
        dec = _decode_mode(words, m)
        out = torch.where((mode == m.mode)[:, None, None], dec, out)
    return out.to(I32)
