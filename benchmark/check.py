"""The comparison that decides ``correct``, and the PSNR.

Both read only the benchmark's own sources and the words the program's
calls emitted as the harness downloaded them; the reference encoder and the
decoder are the frozen plain versions under ``reference/``. Nothing here
imports the program.

Numbers compared, over the blocks sampled from every call of the window
(``record.sample_index``), each block cut from its source level by the
benchmark's own layout, padding included:

- ``sse_excess``: the error of the program's decoded blocks, in the
  metric the configuration's encoder minimises (``enc.error``: squared
  RGBA error for the AMD encoder, bc7enc16's perceptual distance for it),
  summed, over the reference encoder's at the configuration's budget, less
  1 (0 where the words are the reference's; a worse encode reads above 0);
- ``worst_block``: the largest, over those blocks, of the program's error
  less the reference's, over the reference's plus the error of a block one
  level off in every channel of every texel: one wrong answer among many
  shows here;
- ``missing``: calls or requests of the window that failed or never came.

``words_differ``, the share of those blocks whose 128 bits differ from the
reference's, is reported beside them and not compared.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import textures
from .reference.decode_bc7 import _decode_mode, block_modes
from .reference.tables import BC7_MODES

BATCH = 32768             # the reference's blocks per call
DECODE_BLOCKS = 1 << 19


def sampled_blocks(samples, device):
    """(N,16,4) uint8 blocks of every sample on ``device``, and the program's
    words for them (N,4) int32 (None where the samples carry none), in
    sample order."""
    by_level = {}
    for s in samples:
        by_level.setdefault(id(s.level), (s.level, []))[1].append(s)
    blocks, words = [], []
    for level, group in by_level.values():
        b = textures.to_blocks(level.host.to(device))
        idx = torch.from_numpy(np.concatenate([s.idx for s in group])).to(
            device)
        blocks.append(b.index_select(0, idx))
        if group[0].words is not None:
            words.append(np.concatenate([s.words for s in group]))
    if not blocks:
        return (torch.zeros((0, 16, 4), dtype=torch.uint8, device=device),
                torch.zeros((0, 4), dtype=torch.int32, device=device))
    return (torch.cat(blocks), torch.from_numpy(np.concatenate(words)).to(
        device) if words else None)


def decode(words: torch.Tensor) -> torch.Tensor:
    """(N,4) int32 words -> (N,16,4) int32 RGBA, as ``decode_bc7`` gives
    them (a reserved block decodes to zeros), each block decoded under its
    own mode only."""
    mode = block_modes(words)
    out = torch.zeros((words.shape[0], 16, 4), dtype=torch.int32,
                      device=words.device)
    for m in BC7_MODES:
        sel = (mode == m.mode).nonzero().flatten()
        if sel.numel():
            out[sel] = _decode_mode(words[sel], m).to(torch.int32)
    return out


def block_error(enc, words: torch.Tensor, blocks_u8: torch.Tensor):
    """Per-block error of decoded ``words`` against the source blocks, in
    the encoder's metric."""
    return enc.error(decode(words), blocks_u8)


def one_level(enc, device) -> float:
    """The error of a block one level off in every channel of every
    texel."""
    src = torch.full((1, 16, 4), 128, dtype=torch.int32, device=device)
    return enc.error(src + 1, src).item()


def encode_batched(fn, blocks_u8: torch.Tensor) -> torch.Tensor:
    out = [fn(blocks_u8[i:i + BATCH].float() / 255.0)
           for i in range(0, blocks_u8.shape[0], BATCH)]
    return (torch.cat(out) if out else
            torch.zeros((0, 4), dtype=torch.int32, device=blocks_u8.device))


def compare(enc, blocks_u8, prog_words, ref_words) -> dict:
    if blocks_u8.shape[0] == 0:
        return {"sse_excess": 0.0, "worst_block": 0.0, "words_differ": 0.0,
                "blocks": 0}
    ref = block_error(enc, ref_words, blocks_u8)
    prog = block_error(enc, prog_words, blocks_u8)
    floor = one_level(enc, blocks_u8.device)
    return {"sse_excess": prog.sum().item() / max(ref.sum().item(), floor)
            - 1.0,
            "worst_block": ((prog - ref) / (ref + floor)).max().item(),
            "words_differ": (prog_words != ref_words).any(dim=1).double()
            .mean().item(),
            "blocks": int(blocks_u8.shape[0])}


def numbers(run, enc, opts, device) -> dict:
    """The numbers compared for a run (see the module's docstring)."""
    blocks, prog = sampled_blocks(run.samples, device)
    ref = encode_batched(lambda b: enc.reference(b, opts), blocks)
    out = compare(enc, blocks, prog, ref)
    out["missing"] = sum(1 for it in run.items if it.failed) + sum(
        1 for c in run.calls if c.failed)
    return out


def verdict(nums: dict, limits: dict) -> dict:
    """Each number with its limit; a number is within its limit when it is
    at most the limit."""
    return {k: {"value": nums[k], "limit": limits[k]} for k in limits}


def correct(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def psnr(pairs, channels: int, device) -> float:
    """PSNR in dB of the decoded words of ``pairs`` ((Level, word buffer))
    against their sources, over every texel of every level (padding cut)
    and the first ``channels`` channels: one mean squared error over all."""
    sse, count = 0.0, 0
    for level, buf in pairs:
        src = textures.to_blocks(level.host.to(device))
        words = buf.view(-1, 4).to(device)
        dec = torch.cat([decode(words[i:i + DECODE_BLOCKS])
                         for i in range(0, words.shape[0], DECODE_BLOCKS)])
        img = textures.from_blocks(dec, level.h, level.w)[..., :channels]
        ref = textures.from_blocks(src, level.h, level.w)[..., :channels]
        sse += ((img.to(torch.float64) - ref.to(torch.float64)) ** 2
                ).sum().item()
        count += img.numel()
    if count == 0:
        return float("nan")
    mse = sse / count
    return float("inf") if mse == 0 else 10.0 * math.log10(255.0 ** 2 / mse)
