"""Block-axis chunking for the full BC7 encoder.

The JAX package encodes in slabs of a fixed size to bound the memory of its
intermediates and pads the last slab to that size so that no shape change
triggers a recompile. On the card a CUDA kernel takes any block count, so the
port encodes the last slab as it is and pads nothing; the plain versions on
the CPU keep their (16, N) rows per slab small. Every block is encoded alone,
so a chunked call equals one unchunked call block for block.
"""
from __future__ import annotations

import torch


def encode_chunked(encode_fn, blocks: torch.Tensor, chunk: int = 4096):
    """Apply ``encode_fn(blocks_slab) -> (words, err)`` over slabs of at most
    ``chunk`` blocks and concatenate the results."""
    if chunk < 1:
        raise ValueError(f"encode_chunked: chunk {chunk} < 1")
    n = blocks.shape[0]
    if n <= chunk:
        return encode_fn(blocks)
    words_l, err_l = [], []
    for i in range(0, n, chunk):
        w, e = encode_fn(blocks[i:i + chunk])
        words_l.append(w)
        err_l.append(e)
    return torch.cat(words_l, dim=0), torch.cat(err_l, dim=0)
