"""BC7 partition shortlist: CUDA kernel and its plain PyTorch version.

``estimate_topk`` ranks the partitions of ``plist`` for every block by an
estimate of the error a two- or three-subset fit would leave, and returns the
``k`` best partition ids in rank order. It is shared by the fast BC7 encoder
(3 channels, 2 subsets, 8 levels, bounds axis) and by the full BC7 encoder's
multi-subset modes (3 subsets; 4 channels with the PCA axis for mode 7).

For a CUDA tensor the wrapper launches ``csrc/bc7_est_kernel.cu`` (search in
``csrc/bc7_est.cuh``: 8 lanes per block, the partitions dealt to them) and
counts the launch in ``LAUNCHES``; for a CPU tensor it runs the plain version
below. Nothing falls back from one to the other.

``bar`` (an (N,) bool tensor, optional) marks blocks whose caller needs no
shortlist: both the kernel and the plain version give such a block the first
``k`` ids of ``plist`` without ranking it (what an all-equal ranking gives).
The full BC7 encoder passes mode 7's restriction bar there.

The plain version mirrors the JAX package's Pallas body
(``kernels/bc7_full_pallas.py``: ``_estimate``, ``_estimate_pca``, ``_topk``,
``_est_kernel``): a static loop over ``plist``, per subset the pixels of that
subset only, sums as left-to-right chains over those pixels in pixel order,
the first of equal estimates wins. Per subset: centre the pixels on their
mean, project them on an axis (the diagonal of the residual bounding box, or
a 4-round ones-seeded power iteration of the covariance), quantise the
projection to ``levels`` steps between its extremes, and charge the squared
distance to the axis plus the squared quantisation error.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..tables.bc7_tables import P2, P3
from .bc4 import F32, I32

# launches of the CUDA kernel made by the wrapper below; and the same launches
# by configuration, keyed by config_key
LAUNCHES = {"bc7_est": 0}
LAUNCHES_BY_CONFIG: dict = {}

MAX_K = 16                # most ids the CUDA kernel returns (its largest
                          # running-best slot count)
EST_LANES = 8             # the kernel's lanes per block and threads per CTA
EST_THREADS = 128         # (csrc/bc7_est.cuh)
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


def _check(blocks, chans, subsets, plist, levels, k, estimator, bar):
    if bar is not None and (bar.shape != blocks.shape[:1]
                            or bar.dtype != torch.bool
                            or bar.device != blocks.device):
        raise ValueError(f"estimate_topk: bar is an ({blocks.shape[0]},) "
                         f"bool tensor on {blocks.device}")
    if blocks.ndim != 3 or blocks.shape[1] != 16 or blocks.shape[2] < chans:
        raise ValueError(f"estimate_topk: expected (N,16,C>={chans}), got "
                         f"{tuple(blocks.shape)}")
    if chans not in (3, 4) or subsets not in (2, 3):
        raise ValueError("estimate_topk: chans is 3 or 4, subsets 2 or 3")
    if estimator not in ("bounds", "pca"):
        raise ValueError(f"estimate_topk: unknown estimator {estimator!r}")
    if not plist or any(not 0 <= int(p) < 64 for p in plist):
        raise ValueError("estimate_topk: plist holds partition ids 0..63")
    if levels < 2 or k < 1:
        raise ValueError("estimate_topk: levels >= 2 and k >= 1")
    if blocks.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"estimate_topk: unsupported device "
                           f"{blocks.device}")


def estimate_topk(blocks: torch.Tensor, *, chans: int, subsets: int, plist,
                  levels: int, k: int, estimator: str = "bounds",
                  bar=None) -> torch.Tensor:
    """(N,16,4) float32 blocks in [0,1] -> (N, min(k, len(plist))) int32
    partition ids of ``plist`` with the smallest estimates, best first; of
    equal estimates the one earlier in ``plist`` ranks first. A block with
    ``bar`` ((N,) bool, on the blocks' device) set is not ranked: it gets
    ``plist[:k]``.

    The CUDA kernel returns at most ``MAX_K`` (16) ids, which covers every
    ``k`` the encoders ask for (the full BC7 encoder's largest is 9, at quality
    above 0.75 with performance below 1); a larger ``k`` on a CUDA tensor
    raises ``ValueError``. The plain version on a CPU tensor takes any ``k``."""
    _check(blocks, chans, subsets, plist, levels, k, estimator, bar)
    if blocks.device.type == "cpu":
        return estimate_topk_plain(blocks, chans=chans, subsets=subsets,
                                   plist=plist, levels=levels, k=k,
                                   estimator=estimator, bar=bar)
    if blocks.dtype != F32 or blocks.shape[2] != 4 or (
            not blocks.is_contiguous()):
        raise ValueError("estimate_topk: the CUDA kernel takes a contiguous "
                         f"float32 (N,16,4) tensor, got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    plist = tuple(int(p) for p in plist)
    k = min(k, len(plist))
    if k > MAX_K:
        raise ValueError(f"estimate_topk: the CUDA kernel keeps at most "
                         f"{MAX_K} ids, got k={k}")
    from . import _build
    n = blocks.shape[0]
    ids = torch.empty((n, k), dtype=I32, device=blocks.device)
    if n:
        plist_c = (ctypes.c_int * len(plist))(*plist)
        deal_c = (ctypes.c_int * len(plist))(*deal_order(plist, subsets))
        with torch.cuda.device(blocks.device):
            _build.launch("bc7_est_topk", blocks, n, int(chans), int(subsets),
                          plist_c, deal_c, len(plist), int(levels), int(k),
                          int(estimator == "pca"), bar, ids)
        LAUNCHES["bc7_est"] += 1
        key = config_key(chans, subsets, plist, levels, k, estimator)
        LAUNCHES_BY_CONFIG[key] = LAUNCHES_BY_CONFIG.get(key, 0) + 1
    return ids


@functools.lru_cache(maxsize=64)
def deal_order(plist: tuple, subsets: int) -> tuple:
    """The positions of ``plist`` in the order the CUDA kernel deals them to
    its lanes: sorted by the sizes of the partition's subsets (ties in list
    order). A lane loops over a subset's pixels, and the lanes of a warp
    take consecutive deal steps, so neighbouring lanes then loop about as
    long. The ids do not depend on the order (ties rank by list position)."""
    table = P2 if subsets == 2 else P3

    def sizes(j):
        rows = subset_rows(table[int(plist[j])], subsets)
        return tuple(rows.count(s) for s in range(subsets))

    return tuple(sorted(range(len(plist)), key=sizes))


def config_key(chans: int, subsets: int, plist, levels: int, k: int,
               estimator: str = "bounds") -> tuple:
    """The key of ``LAUNCHES_BY_CONFIG`` for one shortlist configuration:
    (chans, subsets, number of partitions, levels, k, estimator), with ``k``
    cut to the number of partitions as the wrapper cuts it."""
    n = len(tuple(plist))
    return (int(chans), int(subsets), n, int(levels), min(int(k), n),
            estimator)
