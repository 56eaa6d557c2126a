"""Dynamic-offset bit-field reads over (N, W) packed words.

BC7 index fields sit at *data-dependent* offsets (anchor pixels drop their
index MSB, and anchor positions depend on the per-block partition id,
amd_bc7_body.cpp:364-421). ``extract_dyn`` reads a field whose bit offset and
width are per-block values, branch-free: the word index turns into a masked
select over the W words. The writer (``insert_dyn``) comes with the BC6H
packer, which is its only caller.
"""
from __future__ import annotations

import torch

from .bitpack import _u32

I64 = torch.int64


def _shift_r(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """v >> s with s in [0, 32]; s == 32 yields 0."""
    return torch.where(s >= 32, 0, v >> torch.clamp(s, max=31))


def _shift_l(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(v << s) mod 2^32 with s in [0, 32]; s == 32 yields 0."""
    return torch.where(s >= 32, 0,
                       (v << torch.clamp(s, max=31)) & 0xFFFFFFFF)


def extract_dyn(words: torch.Tensor, offset: torch.Tensor,
                nbits) -> torch.Tensor:
    """words (N, W) int32 storage, offset (N,) int, nbits int or (N,) ->
    (N,) int64, non-negative."""
    n, w = words.shape
    offset = offset.to(I64)
    widx = offset // 32
    sh = offset % 32
    lo = torch.zeros((n,), dtype=I64, device=words.device)
    hi = torch.zeros((n,), dtype=I64, device=words.device)
    for i in range(w):
        lo = torch.where(widx == i, _u32(words[:, i]), lo)
        if i + 1 < w:
            hi = torch.where(widx == i, _u32(words[:, i + 1]), hi)
    v = _shift_r(lo, sh) | _shift_l(hi, 32 - sh)
    nb = torch.as_tensor(nbits, dtype=I64, device=words.device)
    m = torch.where(nb >= 32, 0xFFFFFFFF,
                    _shift_l(torch.ones_like(v), nb.expand_as(v)) - 1)
    return v & m
