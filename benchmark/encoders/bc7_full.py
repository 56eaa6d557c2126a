"""Full BC7 (the AMD encoder: ``compress(DXBC7, img)`` ->
``compress_amd_bc7``).

The program encodes a level in slabs of ``CHUNK`` blocks; per slab it runs
three partition shortlists (K3: modes 1/3, mode 2, and mode 7's with the
mode 6/7 bar) and one search per mode (K5, eight launches). Mode 0 at the
top tier fits all 16 of its partitions and needs no shortlist.
"""
from __future__ import annotations

import torch

from .. import counts
from ..reference import full

FAST = False
CHUNK = 65536
GUARANTEES = ("quality", "mode_mask", "colour_restrict", "alpha_restrict",
              "performance")


def options(config: dict, control: bool = False) -> dict:
    """The budget of ``encode_bc7_blocks_plain`` that the configuration
    states; with ``control``, with the control's overrides."""
    opts = {k: config["guarantees"][k] for k in GUARANTEES}
    if control:
        opts.update(config["control"])
    return opts


def reference(blocks: torch.Tensor, opts: dict) -> torch.Tensor:
    """(N,16,4) float32 blocks in [0,1] -> (N,4) int32 words."""
    return full.encode_bc7_blocks_plain(blocks, **opts)[0]


def error(decoded: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """Per-block error the encoder minimises: the squared RGBA error, summed
    over the 16 texels, float64."""
    d = decoded.to(torch.float64) - source.to(torch.float64)
    return (d * d).sum(dim=(1, 2))


def stats(blocks: torch.Tensor, opts: dict) -> dict:
    """What the counts read of one level's (N,16,4) float32 blocks: per slab
    its blocks and those the mode 6/7 bar leaves in play; blocks with some
    alpha below 1."""
    bar = full._combined_alpha_bar(blocks, opts["colour_restrict"],
                                   opts["alpha_restrict"])
    n = blocks.shape[0]
    slabs = [(min(CHUNK, n - i), int((~bar[i:i + CHUNK]).sum()))
             for i in range(0, n, CHUNK)]
    return {"blocks": n, "slabs": slabs,
            "alpha_below_1": int((blocks[..., 3] < 1.0).any(1).sum())}


def bounds(st: dict, opts: dict) -> dict:
    """Least seconds of the level's K3 and K5 launches on the card, summed
    launch by launch (``counts.launch_bound``)."""
    plan = full._plan(opts["quality"], opts["mode_mask"],
                      opts["performance"], None, None, None, None)
    budget = dict(iters=plan.iters, shake=plan.shake, uber=plan.uber,
                  keep=plan.keep, topk=plan.shortlists[1]["k"],
                  parts0=plan.shortlists[0] if isinstance(
                      plan.shortlists[0], int) else 16)
    k = budget["topk"]
    k3 = k5 = 0.0
    for n, u in st["slabs"]:
        for mode in (1, 2, 7):                       # the three shortlists
            cfg = plan.shortlists[mode]
            live = u if mode == 7 else n
            ops = counts.ops_bc7_est(
                chans=cfg["chans"], subsets=cfg["subsets"],
                nparts=len(cfg["plist"]), k=cfg["k"],
                pca=cfg.get("estimator") == "pca") * live
            nbytes = 256 * live + 4 * k * n + (n if mode == 7 else 0)
            k3 += counts.launch_bound(ops, nbytes)
        for mode in range(8):                        # one search per mode
            live = n if mode < 6 else u
            ops = counts.ops_bc7_full_mode(mode, **budget) * live
            ops += 64 * n if mode == 0 else 0       # the block scaled once
            nbytes = (256 * live + (n if mode >= 6 else 0) + 20 * n
                      + (4 * n if mode >= 1 else 0)
                      + 4 * k * (n if mode in (1, 2, 3) else 0)
                      + 4 * k * (u if mode == 7 else 0))
            k5 += counts.launch_bound(ops, nbytes)
    return {"k3": k3, "k5": k5}
