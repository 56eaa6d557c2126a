"""Fast BC7 (bc7enc16: ``compress(DXBC7, img, fast=True)`` ->
``compress_richgel999_bc7``).

The program encodes a level in one partition shortlist (K3: 3 channels, 2
subsets) and one search (K4: mode 6 for every block, mode 1 for the opaque
ones).
"""
from __future__ import annotations

import torch

from .. import counts
from ..reference import fast

FAST = True
GUARANTEES = ("fast", "perceptual")


def options(config: dict, control: bool = False) -> dict:
    opts = {k: config["guarantees"][k] for k in GUARANTEES}
    if control:
        opts.update(config["control"])
    return opts


def reference(blocks: torch.Tensor, opts: dict) -> torch.Tensor:
    return fast.encode_bc7_fast_blocks_plain(blocks, **opts)[0]


def error(decoded: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Per-block error the encoder minimises, float64: with ``perceptual``
    (the configurations' setting) bc7enc16's weighted squared distance in
    its YCbCr analog (``fast._YCBCR_M``, weights ``fast.PERCEP_W`` for l,
    cr, cb and alpha), summed over the 16 texels."""
    m = torch.tensor(fast._YCBCR_M, dtype=torch.float64,
                     device=decoded.device)
    w = torch.tensor(fast.PERCEP_W, dtype=torch.float64,
                     device=decoded.device)
    d = decoded.to(torch.float64) - source.to(torch.float64)
    d = torch.cat([d[..., :3] @ m.t(), d[..., 3:]], dim=-1)
    return (d * d * w).sum(dim=(1, 2))


def stats(blocks: torch.Tensor, opts: dict) -> dict:
    """Blocks, opaque blocks (every alpha 1: mode 1 runs), blocks with some
    alpha below 1."""
    below = (blocks[..., 3] < 1.0).any(1)
    opaque = ((blocks[..., 3] * 255.0).amin(1) >= 254.999)
    return {"blocks": blocks.shape[0], "opaque": int(opaque.sum()),
            "alpha_below_1": int(below.sum())}


def bounds(st: dict, opts: dict) -> dict:
    plist, topk, uber = fast._budget(opts["fast"], None, None, None)
    n = st["blocks"]
    k3 = counts.launch_bound(
        counts.ops_bc7_est(chans=3, subsets=2, nparts=len(plist), k=topk) * n,
        (256 + 4 * topk) * n)
    ops4 = counts.ops_bc7_fast(perceptual=opts["perceptual"], uber=uber,
                               k=topk, opaque_frac=st["opaque"] / n) * n
    k4 = counts.launch_bound(ops4, (256 + 4 * topk + 16 + 4) * n)
    return {"k3": k3, "k4": k4}
