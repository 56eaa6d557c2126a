"""BC4 / BC5 encoders: CUDA kernels and their plain PyTorch versions.

``encode_bc4_blocks`` and ``encode_bc5_blocks`` are the wrappers the API
calls. For a CUDA tensor they launch the hand-written kernels of
``csrc/bc45_kernels.cu`` (whose phases are ``csrc/bc45_group.cuh``: a group
of lanes per block and channel, the two ramp families side by side, the
seeds and hill-climb candidates dealt to the lanes) and count the launch in
``LAUNCHES``; for a CPU tensor they run the plain versions below. Nothing
falls back from one to the other.

The plain versions mirror the JAX package's Pallas bodies
(``kernels/bc4_pallas.py``: ``_bc4_search``, ``_bc4_kernel``, ``_bc5_kernel``)
op for op on ``(16, N)`` rows - pixel p of every block in row p - with the
same static unrolling, the same candidate order (first wins on equality) and
the same float32 operation order. One deliberate difference in spelling:
sums over the 16 pixels are written out as a left-to-right chain of adds
(``_sum16``) so that the CPU, the card and the CUDA kernel all add in one
order and agree bit for bit.

The search (amd_bcx_helpers.cpp:125-140 race): an 8-point ramp (a0 > a1) from
a least-squares fit raced against the min/max seed, refined by a joint hill
climb; a 6-point ramp (a0 <= a1, literal 0/255 slots) from a least-squares
seed raced against 9 trimmed-interval seeds taken from the sorted pixels,
refined the same way; the better of the two; exact integer ramps as in
``decode/bcn.py``; DXT5 index packing.
"""
from __future__ import annotations

import torch

from ..bitpack import wrap_u32

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

W8 = (0.0, 1.0, 1 / 7, 2 / 7, 3 / 7, 4 / 7, 5 / 7, 6 / 7)
W6 = (0.0, 1.0, 1 / 5, 2 / 5, 3 / 5, 4 / 5)

# launches of each CUDA kernel made by the wrappers below
LAUNCHES = {"bc4": 0, "bc5": 0}
# the kernels' launch shape (csrc/bc45_group.cuh): lanes per block, channel
# and ramp family (K2a: 2 * BC45_LANES lanes per block, K2b: 4 *
# BC45_LANES), threads per CTA
BC45_LANES = 1
BC45_THREADS = 256


# ------------------------------------------------------------ row helpers ---

def _sum16(x: torch.Tensor) -> torch.Tensor:
    """(16, N) -> (1, N): x[0] + x[1] + ... + x[15], added left to right."""
    acc = x[0:1]
    for p in range(1, 16):
        acc = acc + x[p:p + 1]
    return acc


def _min16(x):
    return torch.amin(x, dim=0, keepdim=True)


def _max16(x):
    return torch.amax(x, dim=0, keepdim=True)


def _round_u8(x):
    """clip(round-half-even(x), 0, 255) as int32."""
    return torch.clamp(torch.round(x), 0, 255).to(I32)


# ---------------------------------------------------------------- search ---

def _palette(a0, a1, eight: bool):
    """Exact integer ramp, list of 8 (1,N) int32 (6-mode pads 0/255)."""
    pal = [a0, a1]
    for i in range(2, 8):
        if eight:
            pal.append(((8 - i) * a0 + (i - 1) * a1 + 3) // 7)
        elif i < 6:
            pal.append(((6 - i) * a0 + (i - 1) * a1 + 2) // 5)
        else:
            pal.append(torch.zeros_like(a0) + (0 if i == 6 else 255))
    return pal


def _assign(vals, pal):
    """vals (16,N) f32, pal list of 8 (1,N) int -> idx (16,N), err (1,N)."""
    best = None
    idx = None
    for k, p in enumerate(pal):
        d = vals - p.to(F32)
        d = d * d
        if best is None:
            best, idx = d, torch.zeros_like(d, dtype=I32)
        else:
            take = d < best
            best = torch.where(take, d, best)
            idx = torch.where(take, k, idx)
    return idx, _sum16(best)


def _assign_err(vals, pal):
    """Error-only variant of :func:`_assign` (the sweep needs no indices)."""
    best = None
    for p in pal:
        d = vals - p.to(F32)
        d = d * d
        best = d if best is None else torch.minimum(best, d)
    return _sum16(best)


def _lsq(vals, alphas, m, e0, e1):
    q00 = _sum16(m * (1 - alphas) ** 2)
    q01 = _sum16(m * alphas * (1 - alphas))
    q11 = _sum16(m * alphas * alphas)
    b0 = _sum16(m * (1 - alphas) * vals)
    b1 = _sum16(m * alphas * vals)
    det = q00 * q11 - q01 * q01
    ok = torch.abs(det) > 1e-6
    inv = 1.0 / torch.where(ok, det, 1.0)
    n0 = (q11 * b0 - q01 * b1) * inv
    n1 = (q00 * b1 - q01 * b0) * inv
    return torch.where(ok, n0, e0), torch.where(ok, n1, e1)


def _fit_ramp(vals, weights, interp_slots: int, iters: int,
              literal_extremes: bool):
    e0 = _min16(vals)
    e1 = _max16(vals)
    lv = weights[:interp_slots]
    for _ in range(iters):
        best = None
        alpha = None
        interior = None
        for l in lv:
            p = e0 + l * (e1 - e0)
            d = (vals - p) ** 2
            if best is None:
                best, alpha = d, torch.zeros_like(d) + l
                interior = torch.ones_like(d)
            else:
                take = d < best
                best = torch.where(take, d, best)
                alpha = torch.where(take, l, alpha)
                interior = torch.where(take, 1.0, interior)
        if literal_extremes:
            for ext in (0.0, 255.0):
                d = (vals - ext) ** 2
                take = d < best
                best = torch.where(take, d, best)
                interior = torch.where(take, 0.0, interior)
        m = interior if literal_extremes else torch.ones_like(vals)
        e0, e1 = _lsq(vals, alpha, m, e0, e1)
    return e0, e1


def _sweep(vals, a0, a1, radius: int, eight: bool, rounds: int):
    """Joint (a0, a1) hill climb; error-only inner loop (indices are
    requantized once for the final winner in :func:`_bc4_search`).
    Rounds after the first use radius 1."""
    best_a0, best_a1 = a0, a1
    best = _assign_err(vals, _palette(a0, a1, eight))
    for r in range(rounds):
        rad = radius if r == 0 else 1
        c_a0, c_a1 = best_a0, best_a1
        for d0 in range(-rad, rad + 1):
            for d1 in range(-rad, rad + 1):
                if d0 == 0 and d1 == 0:
                    continue
                c0 = torch.clamp(c_a0 + d0, 0, 255)
                c1 = torch.clamp(c_a1 + d1, 0, 255)
                ok = (c0 > c1) if eight else (c0 <= c1)
                e2 = _assign_err(vals, _palette(c0, c1, eight))
                e2 = torch.where(ok, e2, 3.4e38)
                take = e2 < best
                best_a0 = torch.where(take, c0, best_a0)
                best_a1 = torch.where(take, c1, best_a1)
                best = torch.where(take, e2, best)
    return best_a0, best_a1, best


def _oem_pairs(n):
    """Batcher odd-even mergesort compare-exchange pairs (n = power of 2)."""
    pairs = []

    def merge(lo, cnt, r):
        m = r * 2
        if m < cnt:
            merge(lo, cnt, m)
            merge(lo + r, cnt, m)
            for i in range(lo + r, lo + cnt - r, m):
                pairs.append((i, i + r))
        else:
            pairs.append((lo, lo + r))

    def sort(lo, cnt):
        if cnt > 1:
            m = cnt // 2
            sort(lo, m)
            sort(lo + m, m)
            merge(lo, cnt, 1)

    sort(0, n)
    return pairs


_SORT16 = _oem_pairs(16)


def _sorted_rows(vals):
    """(16,N) -> list of 16 sorted (1,N) rows via a sorting network."""
    rows = [vals[i:i + 1] for i in range(16)]
    for a, b in _SORT16:
        lo = torch.minimum(rows[a], rows[b])
        hi = torch.maximum(rows[a], rows[b])
        rows[a], rows[b] = lo, hi
    return rows


def _seed8(vals, iters):
    """Start of the 8-point climb (a0 > a1): the least-squares fit raced
    against the min/max seed. Returns (a0, a1), each (1,N) int32."""
    vmin = _round_u8(_min16(vals))
    vmax = _round_u8(_max16(vals))
    e0, e1 = _fit_ramp(vals, W8, 8, iters, False)
    hi = _round_u8(torch.maximum(e0, e1))
    lo = _round_u8(torch.minimum(e0, e1))
    hi8 = torch.where(hi > lo, hi, torch.clamp(hi + 1, max=255))
    vmax8 = torch.where(vmax > vmin, vmax, torch.clamp(vmax + 1, max=255))
    e_fit = _assign_err(vals, _palette(hi8, lo, True))
    e_mm = _assign_err(vals, _palette(vmax8, vmin, True))
    mm = e_mm < e_fit
    return torch.where(mm, vmax8, hi8), torch.where(mm, vmin, lo)


def _seed6(vals, iters):
    """Start of the 6-point climb (a0 <= a1, literal 0/255 slots): the
    least-squares seed raced against the 9 trimmed-interval seeds."""
    e0, e1 = _fit_ramp(vals, W6, 6, iters, True)
    lo6 = _round_u8(torch.minimum(e0, e1))
    hi6 = _round_u8(torch.maximum(e0, e1))
    sv = _sorted_rows(vals)
    seed = (lo6, hi6, _assign_err(vals, _palette(lo6, hi6, False)))
    for i in (0, 1, 2):
        for j in (0, 1, 2):
            s0 = _round_u8(sv[i])
            s1 = _round_u8(sv[15 - j])
            s1 = torch.maximum(s1, s0)
            e = _assign_err(vals, _palette(s0, s1, False))
            take = e < seed[2]
            seed = (torch.where(take, s0, seed[0]),
                    torch.where(take, s1, seed[1]),
                    torch.where(take, e, seed[2]))
    return seed[0], seed[1]


def _bc4_search(vals, iters, radius, rounds):
    """Full scalar-ramp search for one (16,N) channel in 0..255.

    Returns (a0, a1, idx, err) with idx already in DXT5 index space.
    """
    s0, s1 = _seed8(vals, iters)
    a0_8, a1_8, err8 = _sweep(vals, s0, s1, radius, True, rounds)
    s0, s1 = _seed6(vals, iters)
    a0_6, a1_6, err6 = _sweep(vals, s0, s1, radius, False, rounds)

    use8 = err8 <= err6
    a0 = torch.where(use8, a0_8, a0_6)
    a1 = torch.where(use8, a1_8, a1_6)
    err = torch.where(use8, err8, err6)
    # single index requantize for the winner (the mode is implied by
    # a0 <=> a1, so select the palette)
    idx8, _ = _assign(vals, _palette(a0, a1, True))
    idx6, _ = _assign(vals, _palette(a0, a1, False))
    idx = torch.where(use8, idx8, idx6)
    return a0, a1, idx, err


def _pack_dxt5(a0, a1, idx):
    """DXT5-style pack (amd_bcx_helpers.cpp:32-46 layout) -> (w0, w1), each
    (1,N) int64 holding an unsigned 32-bit value (bit 31 of w0 carries the
    low bit of index 5)."""
    idx = idx.to(I64)
    w0 = a0.to(I64) | (a1.to(I64) << 8)
    for p in range(5):
        w0 = w0 | (idx[p:p + 1] << (16 + 3 * p))
    i5 = idx[5:6]
    w0 = w0 | ((i5 & 1) << 31)
    w1 = (i5 & 6) >> 1
    for p in range(6, 16):
        w1 = w1 | (idx[p:p + 1] << (2 + 3 * (p - 6)))
    return w0, w1


def explicit_alpha(a255: torch.Tensor):
    """Explicit 4-bit alpha (BC2's alpha half; the rounding of
    amd_bcx_helpers.cpp:107-123): (16,N) float rows in 0..255 -> ((1,N) int64
    word 0, (1,N) int64 word 1, (1,N) float32 squared error). Integer
    arithmetic, so every device gives the same words."""
    c = torch.clamp(torch.round(a255), 0, 255).to(I32)            # (16,N)
    hi = c >> 4
    q = torch.clamp((c + torch.where(hi < 8, 7, 8) - hi) >> 4, max=15)
    q64 = q.to(I64)
    w0 = q64.new_zeros((1, q64.shape[1]))
    w1 = q64.new_zeros((1, q64.shape[1]))
    for p in range(8):
        w0 = w0 | (q64[p:p + 1] << (4 * p))
        w1 = w1 | (q64[8 + p:9 + p] << (4 * p))
    return w0, w1, _sum16((c - q * 17).to(F32) ** 2)


# ------------------------------------------------------- plain versions ---

def encode_bc4_blocks_plain(vals01: torch.Tensor, *, iters: int = 3,
                            radius: int = 2, rounds: int = 2):
    """(N,16) float scalar blocks in [0,1] -> ((N,2) int32 words, (N,) err).
    Runs on whatever device ``vals01`` lies on."""
    vals = vals01.to(F32).t() * 255.0                      # (16, N)
    a0, a1, idx, err = _bc4_search(vals, iters, radius, rounds)
    w0, w1 = _pack_dxt5(a0, a1, idx)
    words = wrap_u32(torch.cat([w0, w1], dim=0).t().contiguous())
    return words, err[0]


def encode_bc5_blocks_plain(blocks: torch.Tensor, *, iters: int = 3,
                            radius: int = 2, rounds: int = 2):
    """(N,16,C>=2) float blocks in [0,1] -> ((N,4) int32 words, (N,) err):
    the scalar search on R, then on G."""
    x = blocks[..., :2].to(F32).permute(2, 1, 0)           # (2, 16, N)
    r = x[0] * 255.0
    g = x[1] * 255.0
    a0r, a1r, idxr, errr = _bc4_search(r, iters, radius, rounds)
    a0g, a1g, idxg, errg = _bc4_search(g, iters, radius, rounds)
    w0, w1 = _pack_dxt5(a0r, a1r, idxr)
    w2, w3 = _pack_dxt5(a0g, a1g, idxg)
    words = wrap_u32(torch.cat([w0, w1, w2, w3], dim=0).t().contiguous())
    return words, (errr + errg)[0]


def encode_bc2_alpha_blocks(vals01: torch.Tensor):
    """(N,16) float scalar blocks in [0,1] -> ((N,2) int32 explicit 4-bit
    alpha words, (N,) float32 squared error in 0..255 units). No kernel: the
    quantization is elementwise torch arithmetic on the tensor's device."""
    _check_blocks(vals01, 2, 0, "encode_bc2_alpha_blocks")
    w0, w1, err = explicit_alpha(vals01.to(F32).t() * 255.0)
    words = wrap_u32(torch.cat([w0, w1], dim=0).t().contiguous())
    return words, err[0]


# -------------------------------------------------------------- wrappers ---

def _check_blocks(x: torch.Tensor, ndim: int, min_channels: int, name: str):
    if x.ndim != ndim or x.shape[1] != 16 or (
            ndim == 3 and x.shape[2] < min_channels):
        want = "(N,16)" if ndim == 2 else f"(N,16,C>={min_channels})"
        raise ValueError(f"{name}: expected {want}, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: unsupported device {x.device}")
    if x.device.type == "cuda":
        if x.dtype != F32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, "
                            f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes a contiguous "
                             "tensor")


def encode_bc4_blocks(vals01: torch.Tensor, *, iters: int = 3,
                      radius: int = 2, rounds: int = 2):
    """(N,16) float32 scalar blocks in [0,1] -> ((N,2) int32 words,
    (N,) float32 squared error in 0..255 units)."""
    _check_blocks(vals01, 2, 0, "encode_bc4_blocks")
    if vals01.device.type == "cpu":
        return encode_bc4_blocks_plain(vals01, iters=iters, radius=radius,
                                       rounds=rounds)
    from . import _build
    n = vals01.shape[0]
    words = torch.empty((n, 2), dtype=I32, device=vals01.device)
    err = torch.empty((n,), dtype=F32, device=vals01.device)
    if n:
        with torch.cuda.device(vals01.device):
            _build.launch("bc4_encode", vals01, n, words, err,
                          int(iters), int(radius), int(rounds))
        LAUNCHES["bc4"] += 1
    return words, err


def encode_bc5_blocks(blocks: torch.Tensor, *, iters: int = 3,
                      radius: int = 2, rounds: int = 2):
    """(N,16,C>=2) float32 blocks in [0,1] -> ((N,4) int32 words, (N,) err);
    one launch encodes channel 0 then channel 1."""
    _check_blocks(blocks, 3, 2, "encode_bc5_blocks")
    if blocks.device.type == "cpu":
        return encode_bc5_blocks_plain(blocks, iters=iters, radius=radius,
                                       rounds=rounds)
    from . import _build
    n, _, c = blocks.shape
    words = torch.empty((n, 4), dtype=I32, device=blocks.device)
    err = torch.empty((n,), dtype=F32, device=blocks.device)
    if n:
        with torch.cuda.device(blocks.device):
            _build.launch("bc5_encode", blocks, n, int(c), words, err,
                          int(iters), int(radius), int(rounds))
        LAUNCHES["bc5"] += 1
    return words, err
