"""Bit-exact BC6H decoder (14 modes, signed + unsigned, batched, integer math
only).

The C++ library ships no decoder (its decode-side helpers
``decompress_endpoints1/2`` + ``finish_unquantizeF16`` live inside the
encoder, amd_bc6h_body.cpp:1039-1252). Semantics are the exactly-specified
D3D11 19.5 pipeline:

  unquantize (unsigned):  prec >= 15 -> q; 0 -> 0; max -> 0xFFFF;
                          else ((q << 16) + 0x8000) >> prec
  unquantize (signed):    prec >= 16 -> q; on |q|, with (prec-1), max ->
                          0x7FFF; sign reapplied
  palette:                (e0*(64-w) + e1*w + 32) >> 6, 3/4-bit weights
  finish:                 unsigned (v*31) >> 6; signed sign*((|v|*31) >> 5)
                          -> the raw half-float bit pattern (sign-magnitude)

Every block is decoded under each of the 14 static layouts and the one its
mode field names is kept; a block with a reserved mode code decodes to
zeros. Equal, value for value, to the JAX package's ``decode/bc6h.py``.
"""
from __future__ import annotations

import torch

from .. import bitpack
from ..tables.bc6h_tables import (BC6H_MODES, FIELDS, LAYOUTS,
                                  ONE_REGION_INDEX_BIT, TWO_REGION_INDEX_BIT,
                                  TWO_REGION_SHAPE_BIT)
from ..tables.bc7_tables import ANCHOR2, WEIGHTS3, WEIGHTS4, partition_table

I32 = torch.int32
I64 = torch.int64


def _sign_extend(v: torch.Tensor, bits: int) -> torch.Tensor:
    s = 1 << (bits - 1)
    return (v ^ s) - s


def _unquantize(q: torch.Tensor, prec: int, signed: bool) -> torch.Tensor:
    if not signed:
        if prec >= 15:
            return q
        maxq = (1 << prec) - 1
        u = ((q << 16) + 0x8000) >> prec
        u = torch.where(q == 0, 0, u)
        return torch.where(q == maxq, 0xFFFF, u)
    if prec >= 16:
        return q
    a = q.abs()
    maxa = (1 << (prec - 1)) - 1
    u = ((a << 15) + 0x4000) >> (prec - 1)
    u = torch.where(a == 0, 0, u)
    u = torch.where(a >= maxa, 0x7FFF, u)
    return torch.where(q < 0, -u, u)


def _finish(v: torch.Tensor, signed: bool) -> torch.Tensor:
    """Interpolated value -> half-float bit pattern (sign-magnitude)."""
    if not signed:
        return (v * 31) >> 6
    mag = (v.abs() * 31) >> 5
    return torch.where(v < 0, mag | 0x8000, mag)


def half_bits_to_f32(h: torch.Tensor) -> torch.Tensor:
    """(...) integer half bit patterns -> float32."""
    h16 = h.to(I32) & 0xFFFF
    h16 = torch.where(h16 >= 0x8000, h16 - 0x10000, h16).to(torch.int16)
    return h16.view(torch.float16).to(torch.float32)


def _decode_mode(words: torch.Tensor, m, signed: bool) -> torch.Tensor:
    """Decode all blocks as if BC6H mode ``m`` -> (N, 16, 3) int64 half
    bits."""
    n = words.shape[0]
    vals = {f: torch.zeros((n,), dtype=I64, device=words.device)
            for f in FIELDS}
    for field, src, dst, nbits in LAYOUTS[m.mode]:
        vals[field] = vals[field] | (bitpack.extract(words, dst, nbits) << src)

    prec = m.base_bits
    base = [vals["rw"], vals["gw"], vals["bw"]]
    if signed:
        base = [_sign_extend(b, prec) for b in base]
    others = {}
    for i, ch in enumerate("rgb"):
        db = m.delta_bits[i]
        for suff in "xyz":
            v = vals[ch + suff]
            if m.transformed:
                # wrap to prec bits (foreign blocks may overflow; ours never)
                w = (base[i] + _sign_extend(v, db)) & ((1 << prec) - 1)
                if signed:
                    w = _sign_extend(w, prec)
            else:
                w = _sign_extend(v, db) if signed else v
            others[ch + suff] = w

    e = torch.stack(
        [torch.stack(base, -1),
         torch.stack([others["rx"], others["gx"], others["bx"]], -1),
         torch.stack([others["ry"], others["gy"], others["by"]], -1),
         torch.stack([others["rz"], others["gz"], others["bz"]], -1)],
        dim=1)                                            # (N, 4, 3)
    u = _unquantize(e, prec, signed)

    dev = words.device
    if m.regions == 2:
        shape = bitpack.extract(words, TWO_REGION_SHAPE_BIT, 5)
        sub = torch.from_numpy(partition_table(2)[:32]).to(dev, I64)[shape]
        anchor1 = torch.tensor(ANCHOR2, dtype=I64, device=dev)[shape]
        # anchors are always 2, 8 or 15: extract with three static layouts
        # and select
        idx = torch.zeros((n, 16), dtype=I64, device=dev)
        for a in (2, 8, 15):
            pos = TWO_REGION_INDEX_BIT
            cols = []
            for i in range(16):
                wbits = 2 if i in (0, a) else 3
                cols.append(bitpack.extract(words, pos, wbits))
                pos += wbits
            idx = torch.where((anchor1 == a)[:, None],
                              torch.stack(cols, dim=1), idx)
        wtab = torch.tensor(WEIGHTS3, dtype=I64, device=dev)
        s0 = (sub == 0)[:, :, None]
        e0 = torch.where(s0, u[:, 0:1], u[:, 2:3])
        e1 = torch.where(s0, u[:, 1:2], u[:, 3:4])
    else:
        idx = torch.stack(
            [bitpack.extract(words, ONE_REGION_INDEX_BIT, 3)]
            + [bitpack.extract(words, ONE_REGION_INDEX_BIT + 3 + 4 * (i - 1),
                               4) for i in range(1, 16)], dim=1)
        wtab = torch.tensor(WEIGHTS4, dtype=I64, device=dev)
        e0 = u[:, 0:1].expand(n, 16, 3)
        e1 = u[:, 1:2].expand(n, 16, 3)

    w = wtab[idx][:, :, None]                             # (N,16,1)
    v = (e0 * (64 - w) + e1 * w + 32) >> 6
    return _finish(v, signed)


def decode_bc6h_half(words: torch.Tensor, signed: bool = False
                     ) -> torch.Tensor:
    """(N, 4) int32 word storage -> (N, 16, 3) int32 half-float bit
    patterns."""
    code2 = bitpack.extract(words, 0, 2)
    code5 = bitpack.extract(words, 0, 5)
    out = torch.zeros((words.shape[0], 16, 3), dtype=I64, device=words.device)
    for m in BC6H_MODES:
        sel = (code2 == m.code) if m.code_bits == 2 else (code5 == m.code)
        out = torch.where(sel[:, None, None], _decode_mode(words, m, signed),
                          out)
    return out.to(I32)


def decode_bc6h(words: torch.Tensor, signed: bool = False) -> torch.Tensor:
    """(N, 4) int32 word storage -> (N, 16, 3) float32."""
    return half_bits_to_f32(decode_bc6h_half(words, signed))
