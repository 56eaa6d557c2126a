"""What a run records, and what the metric readers read.

Host times are ``time.perf_counter`` seconds; an item's times are counted
from the window's start. A traced run adds the device trace of the window
(``devtrace.TraceData``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import textures

# blocks of each call that the comparison deciding ``correct`` reads, drawn
# from the seed, besides the level's last block (``sample_index``)
CHECK_BLOCKS_PER_CALL = 2


@dataclass
class Level:
    """One source level: its pixels in host memory (uint8 (h, w, 4)), its
    block count and what the counts read of its blocks."""
    host: torch.Tensor
    h: int
    w: int
    blocks: int
    stats: dict
    bounds: dict

    @property
    def texels(self) -> int:
        return self.h * self.w


def make_level(u8: torch.Tensor, host: torch.Tensor, enc, opts) -> Level:
    """Describe the level ``u8`` (on the device) and copy it into ``host``."""
    h, w = int(u8.shape[0]), int(u8.shape[1])
    blocks = textures.to_blocks(u8).float() / 255.0
    st = enc.stats(blocks, opts)
    host.copy_(u8)
    return Level(host, h, w, blocks.shape[0], st, enc.bounds(st, opts))


@dataclass
class Call:
    """One ``compress`` call of the window."""
    texels: int
    host_s: float             # from_array + compress, on the host
    bounds: dict              # kernel id -> least seconds on the card
    failed: bool = False


@dataclass
class Item:
    """A texture (bake: every level of it) or a request (serve)."""
    texels: int
    due: float
    issued: float
    done: Optional[float] = None      # None: never completed

    @property
    def failed(self) -> bool:
        return self.done is None


@dataclass
class Sample:
    """Blocks of one call chosen for the comparison, and the words the
    program gave them."""
    level: Level
    idx: np.ndarray
    words: np.ndarray


@dataclass
class Run:
    cell: str
    seed: int
    seconds: float
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: list = field(default_factory=list)
    items: list = field(default_factory=list)
    samples: list = field(default_factory=list)
    psnr_pairs: list = field(default_factory=list)   # (Level, words host)
    psnr_channels: int = 3
    psnr_db: Optional[float] = None
    launches: Optional[int] = None
    trace: object = None
    notes: list = field(default_factory=list)

    def roofline(self, kernel: str, name_part: str) -> Optional[float]:
        """Share in % of the least time of ``kernel``'s launches in the
        window (the counts) over the device time of the kernels whose name
        holds ``name_part`` (the trace)."""
        if self.trace is None:
            return None
        bound = sum(c.bounds.get(kernel, 0.0) for c in self.calls
                    if not c.failed)
        t = self.trace.kernel_seconds(name_part)
        if bound <= 0.0 or t <= 0.0:
            return None
        return 100.0 * bound / t


def sample_index(seed: int, call_no: int, blocks: int) -> np.ndarray:
    """The blocks of call ``call_no`` that the comparison reads:
    ``CHECK_BLOCKS_PER_CALL`` drawn from the seed, and the last block, which
    holds the level's padding where its sides are not multiples of 4."""
    rng = np.random.default_rng([seed_word(seed), 1, call_no])
    k = min(blocks, CHECK_BLOCKS_PER_CALL)
    idx = rng.choice(blocks, size=k, replace=False)
    return np.unique(np.append(idx, blocks - 1))


def psnr_channels(alphas) -> int:
    """Channels the PSNR reads: RGB where every alpha kind of the mix is
    opaque, RGBA otherwise."""
    return 3 if set(alphas) <= {"opaque"} else 4


def seed_word(seed: int) -> int:
    return int(seed) & 0xFFFF_FFFF_FFFF_FFFF


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed_word(seed), stream])


def percentile(values, q: float) -> Optional[float]:
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
