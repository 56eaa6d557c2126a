"""Frozen copy of the port's ``kernels/bc7_fast.py`` (the fast BC7 encoder's
plain version), kept with the benchmark so that a later change to the
program cannot move the yardstick. Imports nothing of the program.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .bitpack import Sink, wrap_u32
from .tables import ANCHOR2, P2, WEIGHTS3, WEIGHTS4
from .rows import F32, I32, I64, _max16, _min16, _sum16
from .est import _chain, div_scalar, sqrt32

# Partition filterbank for the fast budget: the most frequently winning
# 2-subset shapes (the idea of bc7enc16's filterbank, richgel:139-149).
FAST_PARTITIONS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                   16, 17, 18, 19, 21, 22, 23, 26)

# Integer YCbCr transform of compute_color_distance_rgb (richgel:325-349):
#   l = 109 r + 366 g + 37 b;  cr = (r<<9) - l;  cb = (b<<9) - l, all >>8,
# as one linear map (rows: l', cr', cb'). Every entry is exact in float32.
_YCBCR_M = np.array([[109.0, 366.0, 37.0],
                     [512.0 - 109.0, -366.0, -37.0],
                     [-109.0, -366.0, 512.0 - 37.0]], np.float32) / 256.0
# Channel weights in that space: the perceptual mapping of bc7enc16's
# front end (richgel:1524-1533).
PERCEP_W = (512.0, 103.0, 18.0, 128.0)

LV4 = tuple(w / 64.0 for w in WEIGHTS4)
LV3 = tuple(w / 64.0 for w in WEIGHTS3)
_EPS = 1e-8
_BIG = 3.4e38


@lru_cache(maxsize=1)
def _mode1_solid_table():
    """Optimal mode-1 endpoints per 8-bit channel value and shared p-bit for
    palette index 2 - g_bc7_mode_1_optimal_endpoints (richgel:162-196),
    derived instead of carried as a burned-in table. Returns (lo, hi, err),
    each (256, 2): 6-bit endpoint fields and squared error per p-bit."""
    w2 = WEIGHTS3[2]
    lo = np.arange(64)
    for_p = []
    for p in (0, 1):
        v = ((lo << 1) | p) << 1
        v = v | (v >> 7)                                # decoded 8-bit
        k = (v[:, None] * (64 - w2) + v[None, :] * w2 + 32) >> 6  # (lo,hi)
        c = np.arange(256)[:, None, None]
        err = (k[None] - c) ** 2                        # (256, 64, 64)
        flat = err.reshape(256, -1)
        am = flat.argmin(axis=1)
        for_p.append((am // 64, am % 64, flat.min(axis=1)))
    lo_t = np.stack([f[0] for f in for_p], 1).astype(np.int32)   # (256,2)
    hi_t = np.stack([f[1] for f in for_p], 1).astype(np.int32)
    err_t = np.stack([f[2] for f in for_p], 1).astype(np.float32)
    return lo_t, hi_t, err_t


# ------------------------------------------------------------ row helpers ---

def _lut(values, idx, dtype):
    """values[idx]: a small constant table read per element."""
    return torch.tensor(values, dtype=dtype, device=idx.device)[idx.to(I64)]


def _lerp64(a, b, w):
    return (a * (64 - w) + b * w + 32) >> 6


def _expand7(q, pb):
    """6-bit field + shared pbit -> decoded 8-bit int."""
    x = ((q << 1) | pb) << 1
    return x | (x >> 7)


def _to_metric_rows(xs, perceptual):
    """Channel rows RGB(A) -> metric-space rows (YCbCr analog)."""
    if not perceptual:
        return list(xs)
    m = _YCBCR_M.tolist()
    ycc = [m[d][0] * xs[0] + m[d][1] * xs[1] + m[d][2] * xs[2]
           for d in range(3)]
    return ycc + list(xs[3:])


def _metric_w(perceptual, chans):
    return (PERCEP_W if perceptual else (1.0, 1.0, 1.0, 1.0))[:chans]


def _sel_variants(base, mn, mx, max_sel, uber):
    """Selector variants of the uber machinery on (16,N) indices; mn/mx are
    the (1,N) min/max over the cell."""
    up = (base == mn) & (base < max_sel)
    dn = (base == mx) & (base > 0)
    variants = [torch.where(up, base + 1, base),
                torch.where(dn, base - 1, base),
                torch.where(up, base + 1, torch.where(dn, base - 1, base))]
    if uber >= 2:
        q = (uber - 2) if uber >= 4 else 1
        basef = base.to(F32)
        for ly in range(-q, 2):
            for hy in range(max_sel - 1, max_sel + q + 1):
                if ly == 0 and hy == max_sel:
                    continue
                v = torch.floor(
                    div_scalar(max_sel * (basef - ly), hy - ly) + 0.5)
                variants.append(torch.clamp(v, 0, max_sel).to(I32))
    return variants


def _power_axis(cov, chans, rounds=8):
    """Ones-seeded power iteration on the symmetric covariance ``cov``
    (dict keyed (a,b), a <= b) -> list of (1,N) components, not normalised
    after the last round."""
    v = [torch.ones_like(cov[(0, 0)]) for _ in range(chans)]
    for _ in range(rounds):
        nv = [_chain([cov[(min(a, b), max(a, b))] * v[b]
                      for b in range(chans)]) for a in range(chans)]
        n = sqrt32(_chain([x * x for x in nv]))
        ok = n > _EPS
        inv = 1.0 / torch.clamp(n, min=_EPS)
        v = [torch.where(ok, a * inv, b) for a, b in zip(nv, v)]
    return v


def _normalise(v, fallback):
    n = sqrt32(_chain([x * x for x in v]))
    ok = n > _EPS
    inv = 1.0 / torch.clamp(n, min=_EPS)
    return [torch.where(ok, x * inv, fallback) for x in v]


def _proj_quantize(xs, e0, e1, levels, mw=None):
    """Index of the level nearest to each pixel's projection on e0->e1:
    the count of level midpoints below the projection parameter."""
    chans = len(xs)
    w = mw if mw is not None else (1.0,) * chans
    dirv = [(e1[c] - e0[c]) * w[c] for c in range(chans)]
    l2 = _chain([d * (e1[c] - e0[c]) for c, d in enumerate(dirv)])
    inv = torch.where(l2 > _EPS, 1.0 / torch.clamp(l2, min=_EPS), 0.0)
    t = _chain([(xs[c] - e0[c]) * dirv[c] for c in range(chans)]) * inv
    idx = torch.zeros_like(t, dtype=I32)
    for j in range(len(levels) - 1):
        idx = idx + (t > (levels[j] + levels[j + 1]) * 0.5)
    return idx


def _lsq_multi(xs, alpha, mask, e0, e1):
    """Least-squares endpoints for fixed per-pixel levels ``alpha``; falls
    back to (e0, e1) where the system is singular."""
    m = mask if mask is not None else torch.ones_like(alpha)
    one_a = (1.0 - alpha) * m
    a_m = alpha * m
    q00 = _sum16(one_a * (1.0 - alpha))
    q01 = _sum16(one_a * alpha)
    q11 = _sum16(a_m * alpha)
    det = q00 * q11 - q01 * q01
    ok = torch.abs(det) > 1e-6
    inv = 1.0 / torch.where(ok, det, 1.0)
    ne0, ne1 = [], []
    for c in range(len(xs)):
        b0 = _sum16(one_a * xs[c])
        b1 = _sum16(a_m * xs[c])
        n0 = (q11 * b0 - q01 * b1) * inv
        n1 = (q00 * b1 - q01 * b0) * inv
        ne0.append(torch.where(ok, n0, e0[c]))
        ne1.append(torch.where(ok, n1, e1[c]))
    return ne0, ne1


def _assign_exact(ms, d0, d1, wtab, perceptual):
    """Palette assign in metric space: the index from the quantised
    projection on palette[0]->palette[-1], the error as the exact distance to
    the selected decoder entry. ms: metric-space pixel rows; d0/d1:
    dequantised int endpoints per channel. Returns idx (16,N) int32 and the
    per-pixel distance rows (16,N)."""
    chans = len(d0)
    mw = _metric_w(perceptual, chans)
    levels = tuple(w / float(wtab[-1]) for w in wtab)
    p0 = _to_metric_rows([d.to(F32) for d in d0], perceptual)
    p1 = _to_metric_rows([d.to(F32) for d in d1], perceptual)
    idx = _proj_quantize(ms, p0, p1, levels, mw)
    wk = _lut(wtab, idx, I32)
    sel = _to_metric_rows(
        [_lerp64(d0[c], d1[c], wk).to(F32) for c in range(chans)], perceptual)
    d = torch.zeros_like(ms[0])
    for c in range(chans):
        diff = ms[c] - sel[c]
        d = d + mw[c] * diff * diff
    return idx, d


def _quant_pbit(e, bits, p):
    """Float endpoint 0..255 -> (field, dequantised) under p-bit ``p``."""
    total = bits + 1
    scale = (1 << total) - 1
    wv = e * (scale / 255.0)
    q = torch.clamp(torch.round((wv - p) * 0.5), 0, (1 << bits) - 1).to(I32)
    full = (q << 1) | p
    deq = (full << (8 - total)) | (full >> (2 * total - 8))
    return q, deq


def _take(take, cand, best):
    """Per-block select over tensors in (nested) tuples and lists."""
    if isinstance(cand, (list, tuple)):
        return type(cand)(_take(take, c, b) for c, b in zip(cand, best))
    return torch.where(take, cand, best)


def _pbit_rows(es, bits):
    """Per-endpoint p-bit by the lower endpoint rounding error
    (richgel:606-671); p = 0 wins ties. -> (fields, dequantised, p)."""
    es = [torch.clamp(e, 0.0, 255.0) for e in es]
    best = None
    for p in (0, 1):
        qs, ds = [], []
        err = torch.zeros_like(es[0])
        for e in es:
            q, d = _quant_pbit(e, bits, p)
            qs.append(q)
            ds.append(d)
            err = err + (d.to(F32) - e) ** 2
        cand = (err, qs, ds, torch.full_like(err, p, dtype=I32))
        best = cand if best is None else _take(err < best[0], cand, best)
    return best[1], best[2], best[3]


def _pbit_rows_shared(e0s, e1s, bits):
    """One p-bit for both endpoints of a subset (richgel:676-708)."""
    e0s = [torch.clamp(e, 0.0, 255.0) for e in e0s]
    e1s = [torch.clamp(e, 0.0, 255.0) for e in e1s]
    best = None
    for p in (0, 1):
        q0s, d0s, q1s, d1s = [], [], [], []
        err = torch.zeros_like(e0s[0])
        for e0, e1 in zip(e0s, e1s):
            q0, d0 = _quant_pbit(e0, bits, p)
            q1, d1 = _quant_pbit(e1, bits, p)
            q0s.append(q0)
            d0s.append(d0)
            q1s.append(q1)
            d1s.append(d1)
            err = (err + (d0.to(F32) - e0) ** 2
                   + (d1.to(F32) - e1) ** 2)
        cand = (err, q0s, d0s, q1s, d1s, torch.full_like(err, p, dtype=I32))
        best = cand if best is None else _take(err < best[0], cand, best)
    return best[1:]


# --------------------------------------------------------------- mode 6 ---

def _fit_line4(xs, iters):
    """4-channel PCA + least-squares fit against the 16 levels."""
    chans = len(xs)
    mean = [_sum16(x) / 16.0 for x in xs]
    cen = [x - m for x, m in zip(xs, mean)]
    cov = {(a, b): _sum16(cen[a] * cen[b])
           for a in range(chans) for b in range(a, chans)}
    axis = _normalise(_power_axis(cov, chans), 0.5)
    t = _chain([c * a for c, a in zip(cen, axis)])
    tmin = _min16(t)
    tmax = _max16(t)
    e0 = [m + tmin * a for m, a in zip(mean, axis)]
    e1 = [m + tmax * a for m, a in zip(mean, axis)]
    for _ in range(iters):
        alpha = _lut(LV4, _proj_quantize(xs, e0, e1, LV4), F32)
        e0, e1 = _lsq_multi(xs, alpha, None, e0, e1)
    return e0, e1


def _quant6_race(ms, e0, e1, perceptual, state):
    """Mode-6 quantisation of one endpoint pair, merged into ``state`` =
    (err, q0, q1, idx, p0, p1) on strict <."""
    q0s, d0s, p0 = _pbit_rows(e0, 7)
    q1s, d1s, p1 = _pbit_rows(e1, 7)
    idx, d = _assign_exact(ms, d0s, d1s, WEIGHTS4, perceptual)
    cand = (_sum16(d), q0s, q1s, idx, p0, p1)
    return cand if state is None else _take(cand[0] < state[0], cand, state)


def _mode6(xs, ms, perceptual, uber):
    e0, e1 = _fit_line4(xs, 2)
    state = _quant6_race(ms, e0, e1, perceptual, None)

    def refit(idx, state):
        e0r, e1r = _lsq_multi(xs, _lut(LV4, idx, F32), None, e0, e1)
        return _quant6_race(ms, e0r, e1r, perceptual, state)

    state = refit(state[3], state)
    if uber > 0:
        base = state[3]
        for v in _sel_variants(base, _min16(base), _max16(base), 15, uber):
            state = refit(v, state)
    return state


def _pack_mode6(st):
    _, q0, q1, idx, p0, p1 = st
    # anchor fix-up: the index MSB of pixel 0 must be 0
    need = (idx[0:1] & 8) != 0
    idx = torch.where(need, 15 - idx, idx)
    q0, q1 = ([torch.where(need, b, a) for a, b in zip(q0, q1)],
              [torch.where(need, a, b) for a, b in zip(q0, q1)])
    p0, p1 = torch.where(need, p1, p0), torch.where(need, p0, p1)
    out = Sink(p0.shape, 4, p0.device)
    out.put(torch.full_like(p0, 0x40), 0, 8)
    pos = 7
    for c in range(4):
        out.put(q0[c], pos, 7)
        out.put(q1[c], pos + 7, 7)
        pos += 14
    out.put(p0, 63, 1)
    out.put(p1, 64, 1)
    pos = 65
    for p in range(16):
        nb = 3 if p == 0 else 4
        out.put(idx[p:p + 1], pos, nb)
        pos += nb
    return out.cols


# --------------------------------------------------------------- mode 1 ---

def _fit_masked(xs, m, levels, iters):
    """Masked PCA + least-squares fit of 3 or 4 channels; m is the (16,N) 0/1
    mask, ``levels`` the palette's interpolation levels. The axis falls back
    to 1/sqrt(channels) per component where it vanishes."""
    chans = len(xs)
    cnt = torch.clamp(_sum16(m), min=1.0)
    mean = [_sum16(x * m) / cnt for x in xs]
    cen = [(x - mn) * m for x, mn in zip(xs, mean)]
    cov = {(a, b): _sum16(cen[a] * cen[b])
           for a in range(chans) for b in range(a, chans)}
    axis = _normalise(_power_axis(cov, chans), 1.0 / chans ** 0.5)
    t = _chain([c * a for c, a in zip(cen, axis)])
    tmin = _min16(torch.where(m > 0, t, 1e30))
    tmax = _max16(torch.where(m > 0, t, -1e30))
    tmin = torch.where(tmin > tmax, 0.0, tmin)
    tmax = torch.where(tmax < tmin, 0.0, tmax)
    e0 = [mn + tmin * a for mn, a in zip(mean, axis)]
    e1 = [mn + tmax * a for mn, a in zip(mean, axis)]
    for _ in range(iters):
        alpha = _lut(levels, _proj_quantize(xs, e0, e1, levels), F32)
        e0, e1 = _lsq_multi(xs, alpha, m, e0, e1)
    return e0, e1


def _quant1_subset(ms3, m, e0, e1, perceptual):
    """6-bit endpoints + shared p-bit for one subset, one exact assign.
    -> (err, q0s, q1s, pb, idx)."""
    q0s, d0s, q1s, d1s, pb = _pbit_rows_shared(e0, e1, 6)
    idx, d = _assign_exact(ms3, d0s, d1s, WEIGHTS3, perceptual)
    return (_sum16(d * m), q0s, q1s, pb, idx)


def _subset_masks(sub, s):
    return (sub == s).to(F32)


def _merge1(cand, state):
    """Mode-1 state: (err, errs[2], pid, idx, sub, q0[2][3], q1[2][3],
    pb[2])."""
    return cand if state is None else _take(cand[0] < state[0], cand, state)


def _solid_endpoints(x01):
    """Optimal mode-1 single-colour endpoints for each block's mean colour:
    x01 = three (16,N) rows in 0..1 -> (q0[3], q1[3], pb), each (1,N) int32.
    The p-bit with the smaller summed table error wins, 0 on a tie."""
    lo_t, hi_t, err_t = (torch.from_numpy(t).to(x01[0].device)
                         for t in _mode1_solid_table())
    c = [torch.clamp(torch.round(_sum16(x) / 16.0 * 255.0), 0, 255).to(I64)
         for x in x01]
    errs = [_chain([err_t[ci, p] for ci in c]) for p in (0, 1)]
    pb = (errs[1] < errs[0]).to(I64)
    q0 = [torch.gather(lo_t[ci[0]], 1, pb.t()).t() for ci in c]
    q1 = [torch.gather(hi_t[ci[0]], 1, pb.t()).t() for ci in c]
    return q0, q1, pb.to(I32)


def _solid_candidate(ms3, perceptual, solid):
    """Whole-block single-colour candidate: partition 0, both subsets the
    same endpoints."""
    q0s, q1s, pb = solid
    d0s = [_expand7(q, pb) for q in q0s]
    d1s = [_expand7(q, pb) for q in q1s]
    zero = torch.zeros_like(pb)
    sub = torch.cat([((P2[0] >> p) & 1) + zero for p in range(16)], dim=0)
    m0 = _subset_masks(sub, 0)
    idx, dist = _assign_exact(ms3, d0s, d1s, WEIGHTS3, perceptual)
    err0 = _sum16(dist * m0)
    err1 = _sum16(dist * (1.0 - m0))
    return (err0 + err1, [err0, err1], zero, idx, sub,
            [q0s, q0s], [q1s, q1s], [pb, pb])


def _mode1_uber(xs3, ms3, perceptual, state, uber):
    """Uber selector rounds on the winning partition's subsets. The variants
    of a subset derive from the indices at entry to that subset's loop; the
    least-squares fallback is the entry winner's dequantised endpoints."""
    _, errs, pid, idx, sub, q0, q1, pbs = state
    errs, q0, q1, pbs = list(errs), list(q0), list(q1), list(pbs)
    for s in (0, 1):
        m = _subset_masks(sub, s)
        mi = m > 0
        d0 = [_expand7(q, pbs[s]).to(F32) for q in q0[s]]
        d1 = [_expand7(q, pbs[s]).to(F32) for q in q1[s]]
        mn = _min16(torch.where(mi, idx, 1 << 20))
        mx = _max16(torch.where(mi, idx, -(1 << 20)))
        sbest = (errs[s], q0[s], q1[s], pbs[s], idx)
        for v in _sel_variants(idx, mn, mx, 7, uber):
            e0v, e1v = _lsq_multi(xs3, _lut(LV3, v, F32), m, d0, d1)
            errv, q0v, q1v, pv, idxv = _quant1_subset(ms3, m, e0v, e1v,
                                                      perceptual)
            cand = (errv, q0v, q1v, pv, torch.where(mi, idxv, idx))
            sbest = _take(cand[0] < sbest[0], cand, sbest)
        errs[s], q0[s], q1[s], pbs[s], idx = sbest
    return (errs[0] + errs[1], errs, pid, idx, sub, q0, q1, pbs)


def _mode1(xs3, ms3, perceptual, part_ids, uber, solid):
    state = None
    for k in range(part_ids.shape[1]):
        pid = part_ids[:, k][None, :].to(I32)                  # (1,N)
        maskbits = _lut(P2, pid, I32)
        sub = torch.cat([(maskbits >> p) & 1 for p in range(16)], dim=0)
        errs, q0, q1, pbs = [], [], [], []
        idx_all = None
        for s in (0, 1):
            m = _subset_masks(sub, s)
            e0, e1 = _fit_masked(xs3, m, LV3, 2)
            err, q0s, q1s, pb, idx = _quant1_subset(ms3, m, e0, e1,
                                                    perceptual)
            errs.append(err)
            q0.append(q0s)
            q1.append(q1s)
            pbs.append(pb)
            contrib = idx * (sub == s).to(I32)
            idx_all = contrib if idx_all is None else idx_all + contrib
        state = _merge1((errs[0] + errs[1], errs, pid, idx_all, sub,
                         q0, q1, pbs), state)
    state = _merge1(_solid_candidate(ms3, perceptual, solid), state)
    if uber > 0:
        state = _mode1_uber(xs3, ms3, perceptual, state, uber)
    return state


def _pack_mode1(st):
    _, _, pid, idx, sub, q0, q1, pbs = st
    anchor = _lut(ANCHOR2, pid, I32)
    (q00, q10), (q01, q11) = q0, q1      # qSE: subset S, endpoint E
    pb0, pb1 = pbs
    # subset-0 fix-up (anchor pixel 0)
    need0 = (idx[0:1] & 4) != 0
    in0 = sub == 0
    idx = torch.where(need0 & in0, 7 - idx, idx)
    q00, q01 = ([torch.where(need0, b, a) for a, b in zip(q00, q01)],
                [torch.where(need0, a, b) for a, b in zip(q00, q01)])
    # subset-1 fix-up (anchor = ANCHOR2[pid])
    a_idx = torch.gather(idx, 0, anchor.to(I64))
    need1 = (a_idx & 4) != 0
    idx = torch.where(need1 & ~in0, 7 - idx, idx)
    q10, q11 = ([torch.where(need1, b, a) for a, b in zip(q10, q11)],
                [torch.where(need1, a, b) for a, b in zip(q10, q11)])
    out = Sink(pid.shape, 4, pid.device)
    out.put(torch.full_like(pid, 2), 0, 2)
    out.put(pid, 2, 6)
    pos = 8
    for c in range(3):
        for ep in (q00[c], q01[c], q10[c], q11[c]):
            out.put(ep, pos, 6)
            pos += 6
    out.put(pb0, 80, 1)
    out.put(pb1, 81, 1)
    # index field: pixel 0 and the anchor pixel store one bit fewer
    posd = torch.full_like(pid, 82, dtype=I64)
    for p in range(16):
        nb = 3 - (anchor == p).to(I64) if p else torch.full_like(posd, 2)
        out.put_dyn(idx[p:p + 1], posd, nb)
        posd = posd + nb
    return out.cols


# ------------------------------------------------------- plain version ---

def _budget(fast, _plist, _topk, _uber):
    plist = tuple(_plist) if _plist else (
        FAST_PARTITIONS if fast else tuple(range(64)))
    topk = _topk or (2 if fast else 4)
    uber = (0 if fast else 4) if _uber is None else int(_uber)
    return plist, topk, uber


def bc7_fast_search_plain(blocks: torch.Tensor, part_ids: torch.Tensor, *,
                          perceptual: bool, uber: int):
    """The search alone, given the shortlisted partition ids (N,K):
    (N,16,4) float blocks in [0,1] -> ((N,4) int32 words, (N,) err)."""
    x01 = blocks[..., :4].to(F32).permute(2, 1, 0)             # (4,16,N)
    xs = [x01[c] * 255.0 for c in range(4)]
    has_alpha = _min16(xs[3]) < 254.999
    ms = _to_metric_rows(xs, perceptual)
    st6 = _mode6(xs, ms, perceptual, uber)
    cols6 = _pack_mode6(st6)
    solid = _solid_endpoints([x01[c] for c in range(3)])
    st1 = _mode1(xs[:3], ms[:3], perceptual, part_ids, uber, solid)
    cols1 = _pack_mode1(st1)
    err1 = torch.where(has_alpha, _BIG, st1[0])
    use1 = err1 < st6[0]
    cols = [torch.where(use1, a, b) for a, b in zip(cols1, cols6)]
    words = wrap_u32(torch.cat(cols, dim=0).t().contiguous())
    return words, torch.where(use1, err1, st6[0])[0]


def encode_bc7_fast_blocks_plain(blocks: torch.Tensor, *, fast: bool = False,
                                 perceptual: bool = True, _plist=None,
                                 _topk=None, _uber=None):
    """(N,16,4) float RGBA blocks in [0,1] -> ((N,4) int32 words, (N,) err).
    Runs on whatever device ``blocks`` lies on, shortlist included."""
    from .est import estimate_topk_plain
    plist, topk, uber = _budget(fast, _plist, _topk, _uber)
    ids = estimate_topk_plain(blocks, chans=3, subsets=2, plist=plist,
                              levels=8, k=topk)
    return bc7_fast_search_plain(blocks, ids, perceptual=perceptual,
                                 uber=uber)
