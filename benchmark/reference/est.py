"""Frozen copy of the port's ``kernels/bc7_est.py`` (the partition shortlist's
plain version), kept with the benchmark so that a later change to the
program cannot move the yardstick. Imports nothing of the program.
"""
from __future__ import annotations

import torch

from .tables import P2, P3
from .rows import F32, I32

_BIG = 3.4e38


def subset_rows(pid_bits: int, subsets: int):
    """Subset id per pixel for a packed partition constant."""
    if subsets == 2:
        return [(pid_bits >> p) & 1 for p in range(16)]
    return [(pid_bits >> (2 * p)) & 3 for p in range(16)]


def _chain(terms):
    """terms[0] + terms[1] + ... added left to right."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device. PyTorch's CPU
    float32 ``sqrt`` is off by one ulp on about 1% of inputs, which is enough
    to flip a strict compare between near-equal candidates; the float64 root
    rounded once to float32 is exact (53 >= 2*24 + 2 bits). On a CUDA tensor
    ``torch.sqrt`` is IEEE already."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(F32)
    return torch.sqrt(x)


def div_scalar(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true float32 division. Dividing a CUDA tensor by a Python
    number multiplies by the rounded reciprocal instead, which differs in the
    last bit unless ``d`` is a power of two."""
    return x / torch.full_like(x, d)


def _subset_estimate(x, rows, levels: int, pca: bool, est):
    """Add one subset's estimate to ``est``. x: (C,16,N) in 0..255, rows: the
    subset's pixels in pixel order. Returns the running (N,) sum."""
    nc = x.shape[0]
    cnt = float(len(rows))
    mean = div_scalar(_chain([x[:, p] for p in rows]), cnt)       # (C,N)
    cen = x[:, rows] - mean[:, None]                              # (C,cnt,N)
    if pca:
        cov = {}
        for a in range(nc):
            for b in range(a, nc):
                prod = cen[a] * cen[b]
                cov[(a, b)] = _chain([prod[i] for i in range(len(rows))])
        v = [torch.ones_like(mean[0]) for _ in range(nc)]
        for _ in range(4):
            nv = [_chain([cov[(min(a, b), max(a, b))] * v[b]
                          for b in range(nc)]) for a in range(nc)]
            n = sqrt32(_chain([c * c for c in nv]))
            ok = n > 1e-8
            inv = 1.0 / torch.clamp(n, min=1e-8)
            v = [torch.where(ok, a * inv, b) for a, b in zip(nv, v)]
        axis = v
    else:
        axis = [torch.amax(cen[c], dim=0) - torch.amin(cen[c], dim=0)
                for c in range(nc)]
        n = sqrt32(_chain([a * a for a in axis]))
        inv = 1.0 / torch.clamp(n, min=1e-6)
        axis = [a * inv for a in axis]
    t = _chain([cen[c] * axis[c] for c in range(nc)])             # (cnt,N)
    tmin = torch.amin(t, dim=0)
    tmax = torch.amax(t, dim=0)
    span = torch.clamp(tmax - tmin, min=1e-6)
    tq = torch.round((t - tmin) / span * (levels - 1))
    tr = tq * (1.0 / (levels - 1)) * span + tmin
    d2 = _chain([cen[c] * cen[c] for c in range(nc)]) - t * t
    dq = t - tr
    add = d2 + dq * dq
    for i in range(len(rows)):
        est = add[i] if est is None else est + add[i]
    return est


def estimate_topk_plain(blocks: torch.Tensor, *, chans: int, subsets: int,
                        plist, levels: int, k: int,
                        estimator: str = "bounds",
                        bar=None) -> torch.Tensor:
    """(N,16,C>=chans) float blocks in [0,1] -> (N, min(k, len(plist)))
    int32 partition ids, best first; a block with ``bar`` set gets
    ``plist[:k]``. Runs on the device of ``blocks``."""
    plist = tuple(int(p) for p in plist)
    k = min(k, len(plist))
    if bar is not None:
        ids = torch.tensor(plist[:k], dtype=I32, device=blocks.device).repeat(
            blocks.shape[0], 1)
        keep = ~bar
        if keep.any():
            ids[keep] = estimate_topk_plain(
                blocks[keep], chans=chans, subsets=subsets, plist=plist,
                levels=levels, k=k, estimator=estimator)
        return ids
    x = blocks[..., :chans].to(F32).permute(2, 1, 0) * 255.0      # (C,16,N)
    table = P2 if subsets == 2 else P3
    ests = []
    for pid in plist:
        subs = subset_rows(table[pid], subsets)
        est = None
        for s in range(subsets):
            rows = [p for p in range(16) if subs[p] == s]
            if rows:
                est = _subset_estimate(x, rows, levels, estimator == "pca",
                                       est)
        ests.append(est)
    ids = []
    for _ in range(k):
        best = ests[0]
        bid = torch.full_like(best, plist[0], dtype=I32)
        slot = torch.zeros_like(bid)
        for j in range(1, len(plist)):
            take = ests[j] < best
            best = torch.where(take, ests[j], best)
            bid = torch.where(take, plist[j], bid)
            slot = torch.where(take, j, slot)
        ids.append(bid)
        ests = [torch.where(slot == j, _BIG, e) for j, e in enumerate(ests)]
    return torch.stack(ids, dim=1)
