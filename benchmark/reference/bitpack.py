"""Frozen copy of the port's ``bitpack.py`` (bit fields of packed words), kept
with the benchmark so that a later change to the program cannot move the
yardstick. Imports nothing of the program.
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


def wrap_u32(w: torch.Tensor) -> torch.Tensor:
    """int64 holding an unsigned 32-bit value -> the int32 word storage."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def field_or(words: torch.Tensor, value: torch.Tensor, start: int,
             nbits: int) -> torch.Tensor:
    """OR an ``nbits``-wide field (static offset) into (N, W) int32 words;
    returns new words. ``value``: (N,) any int dtype, masked to ``nbits``.
    Fields may straddle one word boundary (nbits <= 32)."""
    sink = Sink.from_words(words)
    return sink.put(value, start, nbits).words()


class Sink:
    """Column-based block assembler: W independent int64 accumulators, each
    holding an unsigned 32-bit value; one stack at the end. ``n`` is the
    number of blocks, or the shape of a column (the encoders' plain versions
    keep ``(1, N)`` rows)."""

    def __init__(self, n, words_per_block: int, device=None):
        shape = (n,) if isinstance(n, int) else tuple(n)
        self.cols = [torch.zeros(shape, dtype=torch.int64, device=device)
                     for _ in range(words_per_block)]

    @classmethod
    def from_words(cls, words: torch.Tensor) -> "Sink":
        sink = cls(0, 0)
        sink.cols = [_u32(words[:, i]) for i in range(words.shape[1])]
        return sink

    def put(self, value: torch.Tensor, start: int, nbits: int) -> "Sink":
        assert 0 < nbits <= 32
        v = value.to(torch.int64) & mask(nbits)
        w, off = divmod(start, 32)
        self.cols[w] = self.cols[w] | ((v << off) & 0xFFFFFFFF)
        if off + nbits > 32:
            self.cols[w + 1] = self.cols[w + 1] | (v >> (32 - off))
        return self

    def put_indices(self, indices: torch.Tensor, start: int,
                    bits_per_index: int) -> "Sink":
        """Pack (N, 16) per-pixel indices LSB-first from ``start``."""
        for i in range(16):
            self.put(indices[:, i], start + i * bits_per_index,
                     bits_per_index)
        return self

    def put_dyn(self, value: torch.Tensor, start: torch.Tensor,
                nbits: torch.Tensor) -> "Sink":
        """OR a field whose bit offset and width are per-block tensors
        (anchor-dependent index fields)."""
        v = value.to(torch.int64) & ((1 << nbits) - 1)
        w = start // 32
        off = start % 32
        lo = (v << off) & 0xFFFFFFFF
        hi = v >> (32 - off)          # 0 unless the field straddles
        for i in range(len(self.cols)):
            add = torch.where(w == i, lo, 0)
            if i:
                add = add | torch.where(w == i - 1, hi, 0)
            self.cols[i] = self.cols[i] | add
        return self

    def words(self) -> torch.Tensor:
        """(N, W) int32 word storage from (N,) columns."""
        return wrap_u32(torch.stack(self.cols, dim=1))
