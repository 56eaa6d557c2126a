"""BC1 / BC2 / BC3 encoders: CUDA kernels and their plain PyTorch versions.

``encode_bc1_blocks``, ``encode_bc2_blocks`` and ``encode_bc3_blocks`` are the
wrappers the API calls. For a CUDA tensor they launch the hand-written kernels
(``csrc/bc1_kernel.cu``, ``csrc/bc23_kernels.cu``; the colour search is
``csrc/bc1_search.cuh``: for BC1 a group of lanes per block and colour
mode; for BC3 the same groups in the 4-colour mode alone, with the alpha
search ``csrc/bc4_search.cuh`` in warps of its own, one per ramp family,
``csrc/bc23_group.cuh``; for BC2 one thread per block)
and count the launch in ``LAUNCHES``; for a CPU tensor they run the plain
versions below. Nothing falls back from one to the other.

The plain versions mirror the JAX package's Pallas bodies
(``kernels/bc1_pallas.py``: ``_bc1_search``, ``_bc1_kernel``, ``_bc2_kernel``,
``_bc3_kernel``) op for op on ``(16, N)`` rows - pixel p of every block in
row p - with the same static unrolling, the same candidate order (first wins
on equality) and the same float32 operation order. Sums over the 16 pixels are
a left-to-right chain of adds (``_sum16``), so the CPU, the card and the CUDA
kernel add in one order.

The search per block (the C++ library's CompRGBABlock race,
amd_bcx_helpers.cpp:51-105): PCA axis -> endpoint-position sweep along the
axis -> least-squares refits -> 565 quantise -> +/-1 endpoint jitter under the
exact integer palette (or, with ``b3d``, the joint 3-channel cube of
Refine3D) -> 4-colour vs 3-colour race -> pack. With ``use_alpha`` pixels
below the threshold are excluded from the fit and take the transparent index
of the 3-colour mode. Ties between near-equal candidates break toward the
smaller unweighted error (``_tb_take``).
"""
from __future__ import annotations

import torch

from ..options import PERCEPTUAL_WEIGHTS
from .bc4 import (F32, I32, I64, _bc4_search, _check_blocks, _max16, _min16,
                  _pack_dxt5, _sum16, explicit_alpha, wrap_u32)
from .bc7_est import sqrt32

LEVELS4 = (0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0)
LEVELS3 = (0.0, 0.5, 1.0)
_EPS = 1e-8
# Unweighted tie-break threshold: the search optimises the perceptually
# weighted error while quality is judged by unweighted PSNR.
TB_EPS = 0.05

# launches of each CUDA kernel made by the wrappers below
LAUNCHES = {"bc1": 0, "bc2": 0, "bc3": 0}

# K1a's launch shape (csrc/bc1_search.cuh, csrc/bc1_kernel.cu): lanes per
# block and colour mode, and blocks per CTA; a CTA runs both modes of its
# blocks (2 * 32 * 2 threads), or the 4-colour mode alone without
# allow_three (32 * 2). With b3d the cube of a (block, mode) runs on a whole
# warp (BC1_CUBE_LANES lanes), the warp's blocks one after the other.
BC1_LANES = 2
BC1_CTA_BLOCKS = 32
BC1_CUBE_LANES = 32
# K1b's (csrc/bc23_group.cuh): the colour half on K1a's 4-colour groups
# (BC1_LANES lanes per block, BC1_CTA_BLOCKS blocks per CTA), and each alpha
# family of the CTA's blocks in a warp of its own, one thread per block and
# family. K1c is one thread per block, 128 per CTA.
BC3_THREADS = BC1_CTA_BLOCKS * (BC1_LANES + 2)


def _mean16(x):
    return _sum16(x) / 16.0


def _expand_q(qr, qg, qb):
    """565 components -> 8-bit (bit replication), int32."""
    r = (qr << 3) | (qr >> 2)
    g = (qg << 2) | (qg >> 4)
    b = (qb << 3) | (qb >> 2)
    return r, g, b


def _palette_int(q0, q1, four: bool):
    """Exact decode palette rows from 565 components.

    q0/q1: 3-tuples of (1,N) int32. Returns list of K palette entries, each
    a 3-tuple of (1,N) int32 - the rounding of decode/bcn.py.
    """
    e0 = _expand_q(*q0)
    e1 = _expand_q(*q1)
    if four:
        p2 = tuple((2 * a + b + 1) // 3 for a, b in zip(e0, e1))
        p3 = tuple((a + 2 * b + 1) // 3 for a, b in zip(e0, e1))
        return [e0, e1, p2, p3]
    pm = tuple((a + b + 1) >> 1 for a, b in zip(e0, e1))
    return [e0, e1, pm]


def _assign_int(xs, pal, w, m=None):
    """Nearest palette entry under weighted distance.

    xs: 3-tuple of (16,N) f32; pal: list of K 3-tuples of (1,N) int32;
    m: optional (16,N) opaque mask (punch-through path) - masked pixels cost
    nothing (amd_bcx_body.cpp:1223-1231 pixel exclusion).
    Returns idx (16,N) int32, err (1,N) f32.
    """
    best_d = None
    idx = None
    for k, entry in enumerate(pal):
        d = torch.zeros_like(xs[0])
        for c in range(3):
            diff = xs[c] - entry[c].to(F32)
            d = d + w[c] * diff * diff
        if best_d is None:
            best_d, idx = d, torch.zeros_like(d, dtype=I32)
        else:
            take = d < best_d
            best_d = torch.where(take, d, best_d)
            idx = torch.where(take, k, idx)
    if m is not None:
        best_d = best_d * m
    return idx, _sum16(best_d)


def _assign_int2(xs, pal, w, m=None):
    """_assign_int + the UNWEIGHTED error of the weighted assignment."""
    best_d = None
    best_u = None
    idx = None
    for k, entry in enumerate(pal):
        d = torch.zeros_like(xs[0])
        u = torch.zeros_like(xs[0])
        for c in range(3):
            diff = xs[c] - entry[c].to(F32)
            d = d + w[c] * diff * diff
            u = u + diff * diff
        if best_d is None:
            best_d, best_u, idx = d, u, torch.zeros_like(d, dtype=I32)
        else:
            take = d < best_d
            best_d = torch.where(take, d, best_d)
            best_u = torch.where(take, u, best_u)
            idx = torch.where(take, k, idx)
    if m is not None:
        best_d = best_d * m
        best_u = best_u * m
    return idx, _sum16(best_d), _sum16(best_u)


def _tb_take(werr, uerr, best_w, best_u):
    win = werr < best_w * (1.0 - TB_EPS)
    tie = (werr <= best_w * (1.0 + TB_EPS)) & (uerr < best_u)
    return win | tie


def _pca(xs, m=None):
    """PCA axis. xs: 3x(16,N) f32 -> (mean, axis, cen) of (1,N) triples.
    The power iteration starts from ones, as in the JAX package; its roots
    are correctly rounded on every device (``sqrt32``), as the kernel's
    ``sqrtf`` is."""
    if m is None:
        mean = [_mean16(x) for x in xs]
        cen = [x - mn for x, mn in zip(xs, mean)]
    else:
        cnt = torch.clamp(_sum16(m), min=1.0)
        mean = [_sum16(x * m) / cnt for x in xs]
        cen = [(x - mn) * m for x, mn in zip(xs, mean)]
    cov = {}
    for a in range(3):
        for b in range(a, 3):
            cov[(a, b)] = _sum16(cen[a] * cen[b])
    v = [torch.ones_like(mean[0]) for _ in range(3)]
    for _ in range(8):
        nv = [cov[(0, 0)] * v[0] + cov[(0, 1)] * v[1] + cov[(0, 2)] * v[2],
              cov[(0, 1)] * v[0] + cov[(1, 1)] * v[1] + cov[(1, 2)] * v[2],
              cov[(0, 2)] * v[0] + cov[(1, 2)] * v[1] + cov[(2, 2)] * v[2]]
        n = sqrt32(nv[0] * nv[0] + nv[1] * nv[1] + nv[2] * nv[2])
        ok = n > _EPS
        inv = 1.0 / torch.clamp(n, min=_EPS)
        v = [torch.where(ok, a * inv, b) for a, b in zip(nv, v)]
    n = sqrt32(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    ok = n > _EPS
    inv = 1.0 / torch.clamp(n, min=_EPS)
    axis = [torch.where(ok, a * inv, 0.57735026) for a in v]
    return mean, axis, cen


def _iterate_lsq(xs, e0, e1, levels, w, iters: int, m=None):
    """(assign -> LSQ refit) rounds on float endpoints.

    The float palette is exactly collinear, so the weighted-L2 argmin is the
    quantised 1-D projection against the level midpoints - O(K) compares
    instead of K full distance evaluations.
    """
    mids = tuple((levels[j] + levels[j + 1]) * 0.5
                 for j in range(len(levels) - 1))
    for _ in range(iters):
        dirv = [(e1[c] - e0[c]) * w[c] for c in range(3)]
        l2 = sum(d * (e1[c] - e0[c]) for c, d in enumerate(dirv))
        inv = torch.where(l2 > _EPS, 1.0 / torch.clamp(l2, min=_EPS), 0.0)
        t = sum((xs[c] - e0[c]) * dirv[c] for c in range(3)) * inv
        kidx = torch.zeros_like(t, dtype=I32)
        for mid in mids:
            kidx = kidx + (t > mid)
        alpha = torch.zeros_like(t)
        for k, l in enumerate(levels):
            if k:
                alpha = torch.where(kidx == k, l, alpha)
        one_a = 1.0 - alpha
        if m is not None:
            one_a = one_a * m
            a_m = alpha * m
        else:
            a_m = alpha
        q00 = _sum16(one_a * (1.0 - alpha))
        q01 = _sum16(one_a * alpha)
        q11 = _sum16(a_m * alpha)
        det = q00 * q11 - q01 * q01
        okd = torch.abs(det) > 1e-6
        invd = 1.0 / torch.where(okd, det, 1.0)
        for c in range(3):
            b0 = _sum16(one_a * xs[c])
            b1 = _sum16(a_m * xs[c])
            n0 = (q11 * b0 - q01 * b1) * invd
            n1 = (q00 * b1 - q01 * b0) * invd
            e0[c] = torch.where(okd, n0, e0[c])
            e1[c] = torch.where(okd, n1, e1[c])
    return e0, e1


def _sweep1d(t, tmin, tmax, levels, m=None):
    """Endpoint-position search along the projection axis, coarse to fine
    (CompressRGBBlockX, amd_bcx_body.cpp:956-1008): a 4x4 coarse pass over
    the (lo, hi) anchors plus a 3x3 one-step local pass.

    t (16,N) projections -> (lo, hi) (1,N) best ramp positions.
    """
    span = tmax - tmin
    scl0 = tmin - span * 0.125
    s = span * 1.25

    def ramp_err(lo, hi):
        d = None
        for k in levels:
            dk = (t - (lo + k * (hi - lo))) ** 2
            d = dk if d is None else torch.minimum(d, dk)
        if m is not None:
            d = d * m
        return _sum16(d)

    best = None
    for l in range(0, 8, 2):
        for h in range(0, 8, 2):
            lo = scl0 + (0.05 + l * 0.025) * s
            hi = scl0 + (0.95 - h * 0.025) * s
            e = ramp_err(lo, hi)
            if best is None:
                best = (e, lo, hi)
            else:
                take = e < best[0]
                best = (torch.where(take, e, best[0]),
                        torch.where(take, lo, best[1]),
                        torch.where(take, hi, best[2]))
    stp = 0.025 * s
    _, lo0, hi0 = best
    for dl in (-1.0, 0.0, 1.0):
        for dh in (-1.0, 0.0, 1.0):
            if dl == 0.0 and dh == 0.0:
                continue
            lo = lo0 + dl * stp
            hi = hi0 + dh * stp
            e = ramp_err(lo, hi)
            take = e < best[0]
            best = (torch.where(take, e, best[0]),
                    torch.where(take, lo, best[1]),
                    torch.where(take, hi, best[2]))
    return best[1], best[2]


def _mext(t, m):
    """Masked projection extents (big-filler min/max). A block whose every
    pixel is masked out gets extents (0, 0)."""
    if m is None:
        return _min16(t), _max16(t)
    tmin = _min16(torch.where(m > 0, t, 1e30))
    tmax = _max16(torch.where(m > 0, t, -1e30))
    tmin = torch.where(tmin > tmax, 0.0, tmin)
    tmax = torch.where(tmax < tmin, 0.0, tmax)
    return tmin, tmax


def _fit(xs, levels, iters: int, w, m=None):
    """PCA + position sweep + iterative LSQ line fit (two candidates).

    xs: 3x(16,N) f32 in 0..255. Returns two (e0, e1) candidate pairs: one
    started from the projection bounds, one from the position sweep.
    """
    mean, axis, cen = _pca(xs, m)
    t = sum(c * a for c, a in zip(cen, axis))           # (16,N)
    tmin, tmax = _mext(t, m)

    cands = []
    lo_sw, hi_sw = _sweep1d(t, tmin, tmax, levels, m)
    for lo, hi in ((tmin, tmax), (lo_sw, hi_sw)):
        e0 = [mn + lo * a for mn, a in zip(mean, axis)]
        e1 = [mn + hi * a for mn, a in zip(mean, axis)]
        e0, e1 = _iterate_lsq(xs, e0, e1, levels, w, iters, m)
        cands.append((e0, e1))
    return cands


def _quant565(e):
    maxq = (31, 63, 31)
    return [torch.clamp(torch.round(e[c] * (maxq[c] / 255.0)), 0,
                        maxq[c]).to(I32) for c in range(3)]


def _expand_ch(q, ch: int):
    """One 565 component -> decoded 8-bit (bit replication)."""
    return ((q << 2) | (q >> 4)) if ch == 1 else ((q << 3) | (q >> 2))


def _chan_palette(a, b, ch: int, four: bool):
    """Decoded palette values of a single channel from its 565 components."""
    e0 = _expand_ch(a, ch)
    e1 = _expand_ch(b, ch)
    if four:
        return [e0, e1, (2 * e0 + e1 + 1) // 3, (e0 + 2 * e1 + 1) // 3]
    return [e0, e1, (e0 + e1 + 1) >> 1]


def _refine(xs, q0, q1, four: bool, w, passes: int, m=None):
    """Sequential per-channel +/-1 jitter under the exact integer palette.

    Channel-incremental: a (d0,d1) move touches one channel only, so the
    per-entry distance splits into a fixed other-channels part (computed once
    per channel round) plus the moved channel's contribution.
    """
    maxq = (31, 63, 31)
    _, best, best_u = _assign_int2(xs, _palette_int(tuple(q0), tuple(q1),
                                                    four), w, m)
    for _ in range(passes):
        for ch in range(3):
            pal = _palette_int(tuple(q0), tuple(q1), four)
            others = []
            for entry in pal:
                d = torch.zeros_like(xs[0])
                u = torch.zeros_like(xs[0])
                for c in range(3):
                    if c != ch:
                        diff = xs[c] - entry[c].to(F32)
                        d = d + w[c] * diff * diff
                        u = u + diff * diff
                others.append((d, u))
            for d0 in (-1, 0, 1):
                for d1 in (-1, 0, 1):
                    if d0 == 0 and d1 == 0:
                        continue
                    c0 = torch.clamp(q0[ch] + d0, 0, maxq[ch])
                    c1 = torch.clamp(q1[ch] + d1, 0, maxq[ch])
                    ech = _chan_palette(c0, c1, ch, four)
                    dbest = None
                    ubest = None
                    for (other, other_u), e in zip(others, ech):
                        diff = xs[ch] - e.to(F32)
                        dk = other + w[ch] * diff * diff
                        uk = other_u + diff * diff
                        if dbest is None:
                            dbest, ubest = dk, uk
                        else:
                            tk = dk < dbest
                            dbest = torch.where(tk, dk, dbest)
                            ubest = torch.where(tk, uk, ubest)
                    if m is not None:
                        dbest = dbest * m
                        ubest = ubest * m
                    err = _sum16(dbest)
                    uerr = _sum16(ubest)
                    take = _tb_take(err, uerr, best, best_u)
                    best = torch.where(take, err, best)
                    best_u = torch.where(take, uerr, best_u)
                    q0[ch] = torch.where(take, c0, q0[ch])
                    q1[ch] = torch.where(take, c1, q1[ch])
    return q0, q1


def _refine3d(xs, q0, q1, four: bool, w, steps: int, m=None):
    """Joint 3-channel endpoint jitter - Refine3D (amd_bcx_body.cpp:808-932):
    all (2*steps+1)^6 simultaneous channel moves, scored via the per-channel
    distance decomposition. ``steps`` is capped at 1."""
    steps = min(int(steps), 1)
    maxq = (31, 63, 31)
    rng_ = tuple(range(-steps, steps + 1))
    combos = tuple((d0, d1) for d0 in rng_ for d1 in rng_)
    D, Q = [], []
    for c in range(3):
        tabd, tabq = {}, {}
        for d in combos:
            c0 = torch.clamp(q0[c] + d[0], 0, maxq[c])
            c1 = torch.clamp(q1[c] + d[1], 0, maxq[c])
            ech = _chan_palette(c0, c1, c, four)
            tabd[d] = [w[c] * (xs[c] - e.to(F32)) ** 2 for e in ech]
            tabq[d] = (c0, c1)
        D.append(tabd)
        Q.append(tabq)
    best = None
    for dg in combos:
        for db in combos:
            gb = [a + b for a, b in zip(D[1][dg], D[2][db])]
            for dr in combos:
                dbest = None
                for a, b in zip(gb, D[0][dr]):
                    dk = a + b
                    dbest = dk if dbest is None else torch.minimum(dbest, dk)
                if m is not None:
                    dbest = dbest * m
                err = _sum16(dbest)
                cand = (err, Q[0][dr][0], Q[0][dr][1], Q[1][dg][0],
                        Q[1][dg][1], Q[2][db][0], Q[2][db][1])
                if best is None:
                    best = cand
                else:
                    take = cand[0] < best[0]
                    best = tuple(torch.where(take, cc, bb)
                                 for cc, bb in zip(cand, best))
    _, r0, r1, g0, g1, b0, b1 = best
    return [r0, g0, b0], [r1, g1, b1]


def _pack565(q):
    return (q[0] << 11) | (q[1] << 5) | q[2]


def _fit_mode(xs, four: bool, w, iters: int, passes: int, m=None,
              b3d: bool = False):
    levels = LEVELS4 if four else LEVELS3
    best = None
    for e0, e1 in _fit(xs, levels, iters, w, m):
        q0 = _quant565(e0)
        q1 = _quant565(e1)
        _, err = _assign_int(xs, _palette_int(tuple(q0), tuple(q1), four),
                             w, m)
        if best is None:
            best = (err, q0, q1)
        else:
            take = err < best[0]
            best = (torch.where(take, err, best[0]),
                    [torch.where(take, a, b) for a, b in zip(q0, best[1])],
                    [torch.where(take, a, b) for a, b in zip(q1, best[2])])
    _, q0, q1 = best
    if b3d:
        # joint 3-channel cube (Refine3D; either/or dispatch as in the C++
        # library, bcx:1198-1202)
        q0, q1 = _refine3d(xs, q0, q1, four, w, passes, m)
    else:
        q0, q1 = _refine(xs, q0, q1, four, w, passes, m)
    idx, err, uerr = _assign_int2(xs, _palette_int(tuple(q0), tuple(q1),
                                                   four), w, m)
    return q0, q1, idx, err, uerr


def _bc1_search(xs, av, *, weights, iters, passes, allow_three,
                use_alpha=False, athr=0.5, adaptive=False, b3d=False):
    """Full BC1 colour search on channel rows.

    xs: 3 x (16,N) f32 rows in 0..255; av: optional (16,N) alpha rows.
    Returns (a0 (1,N), a1 (1,N), pidx (16,N), err (1,N)) - packed 565
    endpoints with index remaps already applied.
    """
    if adaptive:
        # per-block adaptive colour weights: mean-channel skew applied to
        # the perceptual base (the C++ library's adaptive path reads
        # uninitialised memory, block_utils.cpp:176-211)
        mc = [_mean16(x) for x in xs]
        largest = torch.maximum(torch.maximum(mc[0], mc[1]),
                                torch.clamp(mc[2], min=1e-6))
        w = [weights[c] * (3.0 * mc[c] / largest + 1.0) * 0.25
             for c in range(3)]
        s = w[0] + w[1] + w[2]
        w = tuple(x / s for x in w)
    else:
        w = weights
    if use_alpha:
        opq = av >= athr * 255.0                       # (16,N) bool
        m = opq.to(F32)
        has_t = _min16(m) < 0.5
    else:
        m = None

    q0_4, q1_4, idx4, err4, uerr4 = _fit_mode(xs, True, w, iters, passes,
                                              m, b3d=b3d)
    c0_4 = _pack565(q0_4)
    c1_4 = _pack565(q1_4)
    swap4 = c0_4 < c1_4
    a0_4 = torch.where(swap4, c1_4, c0_4)
    a1_4 = torch.where(swap4, c0_4, c1_4)
    # remap [1,0,3,2] == idx ^ 1
    pidx4 = torch.where(swap4, idx4 ^ 1, idx4)
    degenerate4 = a0_4 == a1_4

    if allow_three:
        q0_3, q1_3, idx3, err3, uerr3 = _fit_mode(xs, False, w, iters,
                                                  passes, m, b3d=b3d)
        c0_3 = _pack565(q0_3)
        c1_3 = _pack565(q1_3)
        swap3 = c0_3 > c1_3
        a0_3 = torch.where(swap3, c1_3, c0_3)
        a1_3 = torch.where(swap3, c0_3, c1_3)
        # remap [1,0,2,3]: flip only indices < 2
        pidx3 = torch.where(swap3 & (idx3 < 2), idx3 ^ 1, idx3)
        if use_alpha:
            # transparent pixels -> index 3 (amd_bcx_body.cpp:269-270);
            # any transparent pixel forces the 3-colour mode
            pidx3 = torch.where(opq, pidx3, 3)
            use4 = _tb_take(err4, uerr4, err3, uerr3) & ~degenerate4 & ~has_t
        else:
            use4 = _tb_take(err4, uerr4, err3, uerr3) & ~degenerate4
        a0 = torch.where(use4, a0_4, a0_3)
        a1 = torch.where(use4, a1_4, a1_3)
        pidx = torch.where(use4, pidx4, pidx3)
        err = torch.where(use4, err4, err3)
    else:
        a0, a1, pidx, err = a0_4, a1_4, pidx4, err4
    return a0, a1, pidx, err


def _pack_bc1(a0, a1, pidx):
    """-> (w0, w1), each (1,N) int64 holding an unsigned 32-bit value."""
    w0 = a0.to(I64) | (a1.to(I64) << 16)
    pidx = pidx.to(I64)
    w1 = torch.zeros_like(w0)
    for p in range(16):
        w1 = w1 | (pidx[p:p + 1] << (2 * p))
    return w0, w1


def _rows(blocks: torch.Tensor, nchan: int):
    """(N,16,C) in [0,1] -> nchan rows (16,N) in 0..255; a missing alpha
    channel reads as opaque."""
    x = blocks[..., :nchan].to(F32)
    if x.shape[-1] < nchan:
        x = torch.cat([x, torch.ones(x.shape[:-1] + (1,), dtype=F32,
                                     device=x.device)], dim=-1)
    x = x.permute(2, 1, 0)
    return [x[c] * 255.0 for c in range(nchan)]


def _words(*rows) -> torch.Tensor:
    return wrap_u32(torch.cat(rows, dim=0).t().contiguous())


# ------------------------------------------------------- plain versions ---

def encode_bc1_blocks_plain(blocks: torch.Tensor,
                            weights: tuple = PERCEPTUAL_WEIGHTS,
                            iters: int = 3, passes: int = 1,
                            allow_three: bool = True,
                            use_alpha: bool = False,
                            alpha_threshold: float = 0.5,
                            adaptive: bool = False, b3d: bool = False):
    """(N,16,C>=3) float blocks in [0,1] -> ((N,2) int32 words, (N,) err).
    Runs on whatever device ``blocks`` lies on."""
    rows = _rows(blocks, 4 if use_alpha else 3)
    av = rows[3] if use_alpha else None
    a0, a1, pidx, err = _bc1_search(
        tuple(rows[:3]), av, weights=weights, iters=iters, passes=passes,
        allow_three=allow_three, use_alpha=use_alpha, athr=alpha_threshold,
        adaptive=adaptive, b3d=b3d)
    return _words(*_pack_bc1(a0, a1, pidx)), err[0]


def encode_bc3_blocks_plain(blocks: torch.Tensor,
                            weights: tuple = PERCEPTUAL_WEIGHTS,
                            iters: int = 3, passes: int = 1,
                            adaptive: bool = False, a_iters: int = 3,
                            a_radius: int = 2, a_rounds: int = 2):
    """BC3: (N,16,4) float blocks in [0,1] -> ((N,4) int32 words, (N,) err).
    Interpolated-alpha block then 4-colour block; the error is the weighted
    colour error plus the unweighted alpha error, as in the JAX package."""
    rows = _rows(blocks, 4)
    a0, a1, pidx, cerr = _bc1_search(
        tuple(rows[:3]), None, weights=weights, iters=iters, passes=passes,
        allow_three=False, adaptive=adaptive)
    cw0, cw1 = _pack_bc1(a0, a1, pidx)
    q0, q1, idx, aerr = _bc4_search(rows[3], a_iters, a_radius, a_rounds)
    aw0, aw1 = _pack_dxt5(q0, q1, idx)
    return _words(aw0, aw1, cw0, cw1), (cerr + aerr)[0]


def encode_bc2_blocks_plain(blocks: torch.Tensor,
                            weights: tuple = PERCEPTUAL_WEIGHTS,
                            iters: int = 3, passes: int = 1,
                            adaptive: bool = False):
    """BC2: (N,16,4) float blocks in [0,1] -> ((N,4) int32 words, (N,) err).
    Explicit 4-bit alpha (rounding of amd_bcx_helpers.cpp:107-123) then
    4-colour block."""
    rows = _rows(blocks, 4)
    a0, a1, pidx, cerr = _bc1_search(
        tuple(rows[:3]), None, weights=weights, iters=iters, passes=passes,
        allow_three=False, adaptive=adaptive)
    cw0, cw1 = _pack_bc1(a0, a1, pidx)
    aw0, aw1, aerr = explicit_alpha(rows[3])
    return _words(aw0, aw1, cw0, cw1), (cerr + aerr)[0]


# -------------------------------------------------------------- wrappers ---

def _weights3(weights):
    w = tuple(float(x) for x in weights)
    if len(w) != 3:
        raise ValueError(f"weights: expected 3 channel weights, got {w}")
    return w


def encode_bc1_blocks(blocks: torch.Tensor,
                      weights: tuple = PERCEPTUAL_WEIGHTS,
                      iters: int = 3, passes: int = 1,
                      allow_three: bool = True, use_alpha: bool = False,
                      alpha_threshold: float = 0.5, adaptive: bool = False,
                      b3d: bool = False):
    """(N,16,C>=3) float32 blocks in [0,1] -> ((N,2) int32 words, (N,)
    float32 weighted squared error in 0..255 units).

    ``use_alpha``: punch-through - pixels whose alpha is below
    ``alpha_threshold`` (0..1) are excluded from the fit and forced to the
    transparent index of the 3-colour mode (amd_bcx_body.cpp:1223-1231,
    :269-270). A tensor without an alpha channel reads as opaque."""
    _check_blocks(blocks, 3, 3, "encode_bc1_blocks")
    w = _weights3(weights)
    if blocks.device.type == "cpu":
        return encode_bc1_blocks_plain(
            blocks, w, iters, passes, allow_three, use_alpha,
            alpha_threshold, adaptive, b3d)
    from . import _build
    n, _, c = blocks.shape
    masked = bool(use_alpha) and c >= 4     # no alpha channel: all opaque
    words = torch.empty((n, 2), dtype=I32, device=blocks.device)
    err = torch.empty((n,), dtype=F32, device=blocks.device)
    if n:
        with torch.cuda.device(blocks.device):
            _build.launch("bc1_encode", blocks, n, int(c), words, err,
                          w[0], w[1], w[2], int(iters), int(passes),
                          int(bool(allow_three)), int(masked),
                          float(alpha_threshold) * 255.0,
                          int(bool(adaptive)), int(bool(b3d)))
        LAUNCHES["bc1"] += 1
    return words, err


def _check_rgba(blocks, name):
    _check_blocks(blocks, 3, 3, name)
    if blocks.device.type == "cuda" and blocks.shape[2] != 4:
        raise ValueError(f"{name}: the CUDA kernel takes (N,16,4), got "
                         f"{tuple(blocks.shape)}")


def encode_bc3_blocks(blocks: torch.Tensor,
                      weights: tuple = PERCEPTUAL_WEIGHTS,
                      iters: int = 3, passes: int = 1,
                      adaptive: bool = False, a_iters: int = 3,
                      a_radius: int = 2, a_rounds: int = 2):
    """BC3: (N,16,4) float32 blocks in [0,1] -> ((N,4) int32 words, (N,) err);
    one launch runs the colour and the alpha search."""
    _check_rgba(blocks, "encode_bc3_blocks")
    w = _weights3(weights)
    if blocks.device.type == "cpu":
        return encode_bc3_blocks_plain(blocks, w, iters, passes, adaptive,
                                       a_iters, a_radius, a_rounds)
    from . import _build
    n = blocks.shape[0]
    words = torch.empty((n, 4), dtype=I32, device=blocks.device)
    err = torch.empty((n,), dtype=F32, device=blocks.device)
    if n:
        with torch.cuda.device(blocks.device):
            _build.launch("bc3_encode", blocks, n, words, err,
                          w[0], w[1], w[2], int(iters), int(passes),
                          int(bool(adaptive)), int(a_iters), int(a_radius),
                          int(a_rounds))
        LAUNCHES["bc3"] += 1
    return words, err


def encode_bc2_blocks(blocks: torch.Tensor,
                      weights: tuple = PERCEPTUAL_WEIGHTS,
                      iters: int = 3, passes: int = 1,
                      adaptive: bool = False):
    """BC2: (N,16,4) float32 blocks in [0,1] -> ((N,4) int32 words, (N,) err);
    one launch runs the colour search and the explicit alpha."""
    _check_rgba(blocks, "encode_bc2_blocks")
    w = _weights3(weights)
    if blocks.device.type == "cpu":
        return encode_bc2_blocks_plain(blocks, w, iters, passes, adaptive)
    from . import _build
    n = blocks.shape[0]
    words = torch.empty((n, 4), dtype=I32, device=blocks.device)
    err = torch.empty((n,), dtype=F32, device=blocks.device)
    if n:
        with torch.cuda.device(blocks.device):
            _build.launch("bc2_encode", blocks, n, words, err,
                          w[0], w[1], w[2], int(iters), int(passes),
                          int(bool(adaptive)))
        LAUNCHES["bc2"] += 1
    return words, err
