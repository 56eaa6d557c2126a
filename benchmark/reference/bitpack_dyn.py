"""Frozen copy of the port's ``bitpack_dyn.py`` (bit fields at per-block
offsets), kept with the benchmark so that a later change to the program
cannot move the yardstick. Imports nothing of the program.
"""
from __future__ import annotations

import torch

from .bitpack import _u32, wrap_u32

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


def insert_dyn(words: torch.Tensor, value: torch.Tensor, offset: torch.Tensor,
               nbits) -> torch.Tensor:
    """OR ``value`` ((N,) any int) at per-block ``offset`` into (N, W) int32
    word storage; returns new words. The caller guarantees that the field
    fits in ``nbits`` (int or (N,)) and that the target bits are zero."""
    n, w = words.shape
    offset = offset.to(I64)
    nb = torch.as_tensor(nbits, dtype=I64, device=words.device).expand(n)
    m = torch.where(nb >= 32, 0xFFFFFFFF,
                    _shift_l(torch.ones((n,), dtype=I64,
                                        device=words.device), nb) - 1)
    v = value.to(I64) & m
    widx = offset // 32
    sh = offset % 32
    lo = _shift_l(v, sh)
    hi = _shift_r(v, 32 - sh)
    cols = []
    for i in range(w):
        add = torch.where(widx == i, lo, 0)
        if i > 0:
            add = add | torch.where(widx == i - 1, hi, 0)
        cols.append(_u32(words[:, i]) | add)
    return wrap_u32(torch.stack(cols, dim=1))
