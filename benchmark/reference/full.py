"""Frozen copy of the port's ``kernels/bc7_full.py`` (the full BC7 encoder's
plain version), kept with the benchmark so that a later change to the
program cannot move the yardstick. Imports nothing of the program.
"""
from __future__ import annotations

import dataclasses

import torch

from .bitpack import Sink, wrap_u32
from .tables import (ANCHOR2, ANCHOR3_1, ANCHOR3_2, BC7_MODES, P2, P3,
                     WEIGHTS2, WEIGHTS3, WEIGHTS4)
from .rows import F32, I32, I64, _max16, _min16, _sum16
from .est import _chain, estimate_topk_plain
from .fast import (_assign_exact, _fit_masked, _lerp64, _lsq_multi, _lut,
                   _quant_pbit, _sel_variants, _take)

WT = {2: WEIGHTS2, 3: WEIGHTS3, 4: WEIGHTS4}
LV = {b: tuple(w / 64.0 for w in t) for b, t in WT.items()}
_BIG = 3.4e38
# channel order per rotation: rotation r swaps channel r - 1 with alpha
ROT_PERMS = ((0, 1, 2, 3), (3, 1, 2, 0), (0, 3, 2, 1), (0, 1, 3, 2))


# ------------------------------------------------------------- host side ---

def _budgets(quality: float):
    """quality -> (partitions listed, shortlist length, fit iterations, shake
    rounds, uber level); the JAX entry's tiers."""
    if quality <= 0.25:
        return 16, 1, 1, 0, 0
    if quality <= 0.5:
        return 32, 2, 2, 1, 1
    if quality <= 0.75:
        return 64, 3, 2, 1, 2
    # topk 8 = the reference's numShakeAttempts = 8 * quality at 1.0
    return 64, 8, 3, 3, 4


def _combined_alpha_bar(blocks, colour_restrict: bool, alpha_restrict: bool):
    """(N,16,4) blocks in [0,1] -> (N,) bool, True where modes 6/7 are barred
    (the reference's mode restriction scan): an opaque, non-solid block under
    ``colour_restrict``; a block with alpha and a 0/1 alpha value under
    ``alpha_restrict``."""
    a = blocks[..., 3]
    needs_alpha = (a < 1.0).any(dim=1)
    zero_one = ((a >= 0.99999) | (a < 0.00001)).any(dim=1)
    pts = blocks * 255.0
    rng = pts.amax(dim=1) - pts.amin(dim=1)                     # (N,4)
    solid = rng.amax(dim=-1) < 1e-10
    bar = torch.zeros_like(needs_alpha)
    if colour_restrict:
        bar = bar | (~solid & ~needs_alpha)
    if alpha_restrict:
        bar = bar | (needs_alpha & zero_one)
    return bar


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What one call runs: per enabled mode, its shortlist configuration (or
    None), and the search budget."""
    modes: tuple
    shortlists: dict          # mode -> estimate_topk kwargs, or int K (0..K-1)
    iters: int
    shake: int
    uber: int
    keep: int


def _plan(quality, mode_mask, performance, _plist, _topk, _shake, _uber):
    """The entry's options -> the _Plan of one call. Performance below 1
    lifts the budget tier and adds one shortlist slot (the JAX entry's
    mapping)."""
    perf = min(max(performance, 0.0), 1.0)
    extra = 0
    if perf < 1.0:
        quality, extra = max(quality, 1.0 - perf), 1
    nparts, topk, iters, shake, uber = _budgets(quality)
    topk = _topk or topk + extra
    if _shake is not None:
        shake = _shake
    if _uber is not None:
        uber = _uber
    plist = tuple(_plist) if _plist else tuple(range(nparts))
    plist16 = tuple(_plist) if _plist else tuple(range(min(nparts, 16)))
    sl = {}
    for m in (1, 3):
        sl[m] = dict(chans=3, subsets=2, plist=plist, levels=8, k=topk)
    sl[2] = dict(chans=3, subsets=3, plist=plist, levels=4, k=topk)
    if quality > 0.75 and not _plist:
        # mode 0 fits all 16 of its partitions at the top tier
        sl[0] = len(plist16)
    else:
        sl[0] = dict(chans=3, subsets=3, plist=plist16, levels=8, k=topk)
    sl[7] = dict(chans=4, subsets=2, plist=plist, levels=4, k=topk,
                 estimator="pca")
    modes = tuple(m for m in range(8) if (mode_mask >> m) & 1)
    return _Plan(modes, {m: sl[m] for m in modes if m in sl}, iters, shake,
                 uber, 2 if quality > 0.75 else 1)


# ----------------------------------------------------------- row helpers ---

def _merge(cand, best):
    """Keyed on element 0, strict <: the incumbent keeps ties."""
    return cand if best is None else _take(cand[0] < best[0], cand, best)


def _sq(x):
    return x * x


def _quant_plain(e, bits):
    """Float endpoint 0..255 -> (field, dequantised) without a p-bit."""
    scale = (1 << bits) - 1
    q = torch.clamp(torch.round(e * (scale / 255.0)), 0, scale).to(I32)
    return q, (q << (8 - bits)) | (q >> (2 * bits - 8))


def _deq(q, p, bits, has_p):
    """Endpoint field (and p-bit) -> decoded 8-bit value."""
    if has_p:
        full, tb = (q << 1) | p, bits + 1
    else:
        full, tb = q, bits
    return (full << (8 - tb)) | (full >> (2 * tb - 8))


def _pbit_combos(mode):
    if mode.pbit_mode == "per_endpoint":
        return ((0, 0), (0, 1), (1, 0), (1, 1))
    if mode.pbit_mode == "shared":
        return ((0, 0), (1, 1))
    return ((None, None),)


def _bits(mode, nc):
    return [mode.colour_bits if c < 3 else mode.alpha_bits for c in range(nc)]


def _subsets(pid, subsets):
    """(1,N) partition ids -> (16,N) subset id per pixel."""
    if subsets == 1:
        return torch.zeros((16,) + tuple(pid.shape[1:]), dtype=I32,
                           device=pid.device)
    bits = _lut(P2 if subsets == 2 else P3, pid, I64)
    step, fld = (1, 1) if subsets == 2 else (2, 3)
    return torch.cat([(bits >> (step * p)) & fld for p in range(16)],
                     dim=0).to(I32)


def _assign(xs, m, d0s, d1s, wtab):
    """Exact palette assign, RGB(A) metric: (16,N) indices and the masked
    error sum."""
    idx, d = _assign_exact(xs, d0s, d1s, wtab, False)
    return idx, _sum16(d * m)


# ----------------------------------------------------------- subset steps ---

def _quant_subset(xs, m, mode, e0, e1, race):
    """Quantise one subset's float endpoints against the exact palette.
    Without p-bits: one assign. With p-bits: the combinations are raced by the
    endpoints' rounding error; the winner (and with ``race`` 2 the best loser
    too) is assigned exactly. -> (err, q0s, q1s, pb0, pb1, idx)."""
    nc = len(xs)
    bits = _bits(mode, nc)
    wtab = WT[mode.index_bits]
    if mode.pbit_mode == "none":
        q0s, d0s = zip(*[_quant_plain(e, b) for e, b in zip(e0, bits)])
        q1s, d1s = zip(*[_quant_plain(e, b) for e, b in zip(e1, bits)])
        idx, err = _assign(xs, m, d0s, d1s, wtab)
        z = torch.zeros_like(err, dtype=I32)
        return (err, list(q0s), list(q1s), z, z, idx)
    e0c = [torch.clamp(e, 0.0, 255.0) for e in e0]
    e1c = [torch.clamp(e, 0.0, 255.0) for e in e1]
    pick = pick2 = None
    for p0, p1 in _pbit_combos(mode):
        q0s, d0s = zip(*[_quant_pbit(e, b, p0) for e, b in zip(e0c, bits)])
        q1s, d1s = zip(*[_quant_pbit(e, b, p1) for e, b in zip(e1c, bits)])
        perr = _chain([_sq(d0s[c].to(F32) - e0c[c])
                       + _sq(d1s[c].to(F32) - e1c[c]) for c in range(nc)])
        z = torch.zeros_like(perr, dtype=I32)
        cand = (perr, list(q0s), list(q1s), list(d0s), list(d1s), z + p0,
                z + p1)
        if pick is None:
            pick = cand
            continue
        take = cand[0] < pick[0]
        loser = _take(take, pick, cand)
        pick = _take(take, cand, pick)
        if race > 1:
            pick2 = _merge(loser, pick2)
    best = None
    for pk in ([pick, pick2] if race > 1 and pick2 is not None else [pick]):
        _, q0s, q1s, d0s, d1s, pb0, pb1 = pk
        idx, err = _assign(xs, m, d0s, d1s, wtab)
        best = _merge((err, q0s, q1s, pb0, pb1, idx), best)
    return best


def _uber_rows(xs, m, mode, st, uber, race):
    """Uber selector rounds on one subset. st = (err, q0s, q1s, pb0, pb1,
    idx); the variants come from the indices at entry, the least-squares
    fallback is the entry's dequantised endpoints."""
    err, q0s, q1s, pb0, pb1, idx = st
    nc = len(xs)
    has_p = mode.pbit_mode != "none"
    bits = _bits(mode, nc)
    d0 = [_deq(q0s[c], pb0, bits[c], has_p).to(F32) for c in range(nc)]
    d1 = [_deq(q1s[c], pb1, bits[c], has_p).to(F32) for c in range(nc)]
    mi = m > 0
    mn = _min16(torch.where(mi, idx, 1 << 20))
    mx = _max16(torch.where(mi, idx, -(1 << 20)))
    best = st
    lv = LV[mode.index_bits]
    for v in _sel_variants(idx, mn, mx, (1 << mode.index_bits) - 1, uber):
        e0v, e1v = _lsq_multi(xs, _lut(lv, v, F32), m, d0, d1)
        cand = _quant_subset(xs, m, mode, e0v, e1v, race)
        cand = cand[:5] + (torch.where(mi, cand[5], idx),)
        best = _merge(cand, best)
    return best


def _shake_rows(xs, m, mode, st, rounds, srange):
    """Quantised-space endpoint shaker on one subset. Per round: the weights
    come from the indices at its start; channel by channel, greedily, the
    endpoint steps (da, db) in [-srange, srange]^2 around the round's start
    codes; then a p-bit re-race and an index requantise inside the subset.
    The error returned is the re-race's."""
    err, q0s, q1s, pb0, pb1, idx = st
    q0s, q1s = list(q0s), list(q1s)
    nc = len(xs)
    has_p = mode.pbit_mode != "none"
    bits = _bits(mode, nc)
    wtab = WT[mode.index_bits]
    deltas = [(a, b) for a in range(-srange, srange + 1)
              for b in range(-srange, srange + 1) if (a, b) != (0, 0)]
    for _ in range(rounds):
        wk = _lut(wtab, idx, I32)
        for c in range(nc):
            maxq = (1 << bits[c]) - 1
            q0c, q1c = q0s[c], q1s[c]

            def ch_err(a, b, c=c):
                diff = (_lerp64(_deq(a, pb0, bits[c], has_p),
                                _deq(b, pb1, bits[c], has_p), wk).to(F32)
                        - xs[c])
                return _sum16(m * diff * diff)

            best_e, b0, b1 = ch_err(q0c, q1c), q0c, q1c
            for da, db in deltas:
                nq0 = torch.clamp(q0c + da, 0, maxq)
                nq1 = torch.clamp(q1c + db, 0, maxq)
                e = ch_err(nq0, nq1)
                take = e < best_e
                best_e = torch.where(take, e, best_e)
                b0 = torch.where(take, nq0, b0)
                b1 = torch.where(take, nq1, b1)
            q0s[c], q1s[c] = b0, b1
        best = None
        for c0, c1 in _pbit_combos(mode):
            np0 = pb0 if c0 is None else torch.zeros_like(pb0) + c0
            np1 = pb1 if c1 is None else torch.zeros_like(pb1) + c1
            d0s = [_deq(q0s[c], np0, bits[c], has_p) for c in range(nc)]
            d1s = [_deq(q1s[c], np1, bits[c], has_p) for c in range(nc)]
            nidx, ne = _assign(xs, m, d0s, d1s, wtab)
            best = _merge((ne, np0, np1, nidx), best)
        err, pb0, pb1, nidx = best
        idx = torch.where(m > 0, nidx, idx)
    return err, q0s, q1s, pb0, pb1, idx


# ------------------------------------------------------ single-index modes ---

def _single_mode(xs, mode, part_ids, iters, shake, uber):
    """Modes 0/1/2/3/6/7. xs: channel rows (3, or 4 for modes 6/7);
    part_ids: (N,K) int32 shortlist (unused by the one-subset mode 6).
    State: (err, errs[S], pid, idx, q0[S][C], q1[S][C], pb0[S], pb1[S])."""
    s_count = mode.subsets
    levels = LV[mode.index_bits]
    if s_count == 1:
        ids = [torch.zeros_like(xs[0][0:1], dtype=I32)]
    else:
        ids = [part_ids[:, k][None, :].to(I32)
               for k in range(part_ids.shape[1])]
    keep2 = (mode.colour_bits <= 5 and s_count >= 2 and len(ids) > 1
             and bool(uber or shake))
    low4 = mode.colour_bits <= 4 and mode.pbit_mode != "none"
    race = 2 if low4 else 1
    if low4 and uber:
        uber += 2
    best = best2 = None
    for pid in ids:
        sub = _subsets(pid, s_count)
        errs, q0l, q1l, pb0l, pb1l = [], [], [], [], []
        idx_all = None
        for s in range(s_count):
            m = (sub == s).to(F32)
            e0, e1 = _fit_masked(xs, m, levels, iters)
            err, q0s, q1s, pb0, pb1, idx = _quant_subset(xs, m, mode, e0, e1,
                                                         race)
            errs.append(err)
            q0l.append(q0s)
            q1l.append(q1s)
            pb0l.append(pb0)
            pb1l.append(pb1)
            contrib = idx * (sub == s).to(I32)
            idx_all = contrib if idx_all is None else idx_all + contrib
        cand = (_chain(errs), errs, pid, idx_all, q0l, q1l, pb0l, pb1l)
        if best is None:
            best = cand
        elif keep2:
            take = cand[0] < best[0]
            demoted = _take(take, best, cand)
            best = _take(take, cand, best)
            best2 = _merge(demoted, best2)
        else:
            best = _merge(cand, best)

    def refine(st):
        _, errs, pid, idx, q0l, q1l, pb0l, pb1l = st
        errs, q0l, q1l = list(errs), list(q0l), list(q1l)
        pb0l, pb1l = list(pb0l), list(pb1l)
        sub = _subsets(pid, s_count)
        for s in range(s_count):
            m = (sub == s).to(F32)
            sst = (errs[s], q0l[s], q1l[s], pb0l[s], pb1l[s], idx)
            if uber:
                sst = _uber_rows(xs, m, mode, sst, uber, race)
            if shake:
                sst = _shake_rows(xs, m, mode, sst, shake,
                                  2 if shake >= 3 else 1)
            errs[s], q0l[s], q1l[s], pb0l[s], pb1l[s], idx = sst
        return (_chain(errs), errs, pid, idx, q0l, q1l, pb0l, pb1l)

    if uber or shake:
        best = refine(best)
        if keep2:
            best = _merge(refine(best2), best)
    return best


def _pack_single(mode, st):
    """Anchor fix-ups (a subset whose anchor index has its MSB set gets its
    indices complemented and its endpoints and p-bits swapped), then the
    fields. -> list of 4 (1,N) int64 word columns."""
    _, _, pid, idx, q0l, q1l, pb0l, pb1l = st
    q0l = [list(q) for q in q0l]
    q1l = [list(q) for q in q1l]
    pb0l, pb1l = list(pb0l), list(pb1l)
    s_count, ib = mode.subsets, mode.index_bits
    comp, msb = (1 << ib) - 1, 1 << (ib - 1)
    anchors = [None]
    if s_count == 2:
        anchors.append(_lut(ANCHOR2, pid, I64))
    elif s_count == 3:
        anchors += [_lut(ANCHOR3_1, pid, I64), _lut(ANCHOR3_2, pid, I64)]
    sub = _subsets(pid, s_count)
    for s in range(s_count):
        a_idx = idx[0:1] if anchors[s] is None else torch.gather(
            idx, 0, anchors[s])
        need = (a_idx & msb) != 0
        idx = torch.where(need & (sub == s), comp - idx, idx)
        q0l[s], q1l[s] = (_take(need, q1l[s], q0l[s]),
                          _take(need, q0l[s], q1l[s]))
        pb0l[s], pb1l[s] = (torch.where(need, pb1l[s], pb0l[s]),
                            torch.where(need, pb0l[s], pb1l[s]))
    out = Sink(pid.shape, 4, pid.device)
    out.put(torch.full_like(pid, 1 << mode.mode), 0, mode.mode + 1)
    pos = mode.mode + 1
    if mode.partition_bits:
        out.put(pid, pos, mode.partition_bits)
        pos += mode.partition_bits
    for c in range(4 if mode.alpha_bits else 3):
        bits = mode.colour_bits if c < 3 else mode.alpha_bits
        for s in range(s_count):
            out.put(q0l[s][c], pos, bits)
            out.put(q1l[s][c], pos + bits, bits)
            pos += 2 * bits
    if mode.pbit_mode != "none":
        for s in range(s_count):
            out.put(pb0l[s], pos, 1)
            pos += 1
            if mode.pbit_mode == "per_endpoint":
                out.put(pb1l[s], pos, 1)
                pos += 1
    # pixel 0 and each subset's anchor pixel store one index bit fewer
    posd = torch.full_like(pid, pos, dtype=I64)
    for p in range(16):
        nb = torch.full_like(posd, ib - (1 if p == 0 else 0))
        for a in anchors[1:]:
            nb = nb - (a == p).to(I64)
        out.put_dyn(idx[p:p + 1], posd, nb)
        posd = posd + nb
    return out.cols


# --------------------------------------------------------- dual-index modes ---

def _fit_scalar(vals, bits, ib, iters):
    """Scalar endpoints of the rotated channel: min/max, ``iters``
    least-squares rounds against the nearest level, quantised; then each
    pixel's nearest palette entry. -> (err, q0, q1, idx)."""
    lv = LV[ib]
    e0, e1 = _min16(vals), _max16(vals)
    for _ in range(iters):
        bestd = alpha = None
        for lvl in lv:
            d = _sq(vals - (e0 + lvl * (e1 - e0)))
            if bestd is None:
                bestd, alpha = d, torch.zeros_like(d) + lvl
            else:
                take = d < bestd
                bestd = torch.where(take, d, bestd)
                alpha = torch.where(take, lvl, alpha)
        e0, e1 = _lsq_scalar(vals, alpha, e0, e1)
    q0, d0 = _quant_plain(e0, bits)
    q1, d1 = _quant_plain(e1, bits)
    idx, err = _nearest_scalar(vals, d0, d1, WT[ib])
    return err, q0, q1, idx


def _lsq_scalar(vals, a, f0, f1):
    """Least-squares scalar endpoints for fixed levels ``a``; (f0, f1) where
    the system is singular."""
    one_a = 1.0 - a
    q00 = _sum16(one_a * one_a)
    q01 = _sum16(one_a * a)
    q11 = _sum16(a * a)
    det = q00 * q11 - q01 * q01
    ok = torch.abs(det) > 1e-6
    inv = 1.0 / torch.where(ok, det, 1.0)
    b0 = _sum16(one_a * vals)
    b1 = _sum16(a * vals)
    n0 = (q11 * b0 - q01 * b1) * inv
    n1 = (q00 * b1 - q01 * b0) * inv
    return torch.where(ok, n0, f0), torch.where(ok, n1, f1)


def _nearest_scalar(vals, d0, d1, wtab):
    """Each pixel's nearest entry of the decoded scalar palette (first of
    equals) -> (idx (16,N), summed squared error)."""
    bestd = idx = None
    for k, wk in enumerate(wtab):
        d = _sq(vals - _lerp64(d0, d1, wk).to(F32))
        if bestd is None:
            bestd, idx = d, torch.zeros_like(d, dtype=I32)
        else:
            take = d < bestd
            bestd = torch.where(take, d, bestd)
            idx = torch.where(take, k, idx)
    return idx, _sum16(bestd)


def _uber_scalar_rows(vals, bits, ib, st, uber):
    """Uber selector rounds on the scalar channel; the least-squares fallback
    is (0, 255). st = (err, q0, q1, idx)."""
    idx = st[3]
    best = st
    for v in _sel_variants(idx, _min16(idx), _max16(idx), (1 << ib) - 1,
                           uber):
        e0, e1 = _lsq_scalar(vals, _lut(LV[ib], v, F32),
                             torch.zeros_like(st[0]),
                             torch.full_like(st[0], 255.0))
        q0, d0 = _quant_plain(e0, bits)
        q1, d1 = _quant_plain(e1, bits)
        nidx, err = _nearest_scalar(vals, d0, d1, WT[ib])
        best = _merge((err, q0, q1, nidx), best)
    return best


def _submode(mode, bits, ib):
    """The view of a dual mode's channel group that the subset steps take:
    one subset, no p-bits, ``bits`` per endpoint, ``ib`` index bits."""
    return dataclasses.replace(mode, subsets=1, colour_bits=bits,
                               alpha_bits=0, pbit_mode="none", index_bits=ib)


def _dual_mode(xs, mode, iters, shake, uber, keep):
    """Modes 4/5. State: (err, cerr, aerr, rot, sel, qc0[3], qc1[3], qa0,
    qa1, cidx, aidx)."""
    keep2 = keep > 1 and bool(uber or shake)
    ones = torch.ones_like(xs[0])
    zero = torch.zeros_like(xs[0][0:1], dtype=I32)
    nsel = 1 << mode.index_mode_bits
    best = best2 = None
    for rot in range(4):
        rgb = [xs[i] for i in ROT_PERMS[rot][:3]]
        alpha = xs[ROT_PERMS[rot][3]]
        for sel in range(nsel):
            cib = mode.index_bits2 if sel else mode.index_bits
            aib = mode.index_bits if sel else mode.index_bits2
            e0, e1 = _fit_masked(rgb, ones, LV[cib], iters)
            cerr, qc0, qc1, _, _, cidx = _quant_subset(
                rgb, ones, _submode(mode, mode.colour_bits, cib), e0, e1, 1)
            aerr, qa0, qa1, aidx = _fit_scalar(alpha, mode.alpha_bits, aib,
                                               iters)
            cand = (cerr + aerr, cerr, aerr, zero + rot, zero + sel, qc0, qc1,
                    qa0, qa1, cidx, aidx)
            if best is None:
                best = cand
            elif keep2:
                take = cand[0] < best[0]
                demoted = _take(take, best, cand)
                best = _take(take, cand, best)
                best2 = _merge(demoted, best2)
            else:
                best = _merge(cand, best)

    def refine(st):
        err, cerr, aerr, rot, sel, qc0, qc1, qa0, qa1, cidx, aidx = st
        chans = []
        for c in range(4):
            px = None
            for r in range(4):
                src = xs[ROT_PERMS[r][c]]
                px = src if px is None else torch.where(rot == r, src, px)
            chans.append(px)
        rgb, alpha = chans[:3], chans[3]
        for sv in range(nsel):
            cib = mode.index_bits2 if sv else mode.index_bits
            aib = mode.index_bits if sv else mode.index_bits2
            cmode = _submode(mode, mode.colour_bits, cib)
            # a block takes this path's result only if its own selection is
            # sv; the others' indices are clamped to the path's widths so the
            # tables can be read, and their results are dropped
            cst = (cerr, qc0, qc1, zero, zero,
                   torch.clamp(cidx, max=(1 << cib) - 1))
            ast = (aerr, qa0, qa1, torch.clamp(aidx, max=(1 << aib) - 1))
            if uber:
                cst = _uber_rows(rgb, ones, cmode, cst, min(uber, 2), 1)
                ast = _uber_scalar_rows(alpha, mode.alpha_bits, aib, ast,
                                        min(uber, 2))
            if shake:
                cst = _shake_rows(rgb, ones, cmode, cst, shake, 1)
                a_st = _shake_rows(
                    [alpha], ones, _submode(mode, mode.alpha_bits, aib),
                    (ast[0], [ast[1]], [ast[2]], zero, zero, ast[3]), shake,
                    1)
                ast = (a_st[0], a_st[1][0], a_st[2][0], a_st[5])
            tk = (cst[0] + ast[0]) < err
            if nsel > 1:
                tk = tk & (sel == sv)
            cerr = torch.where(tk, cst[0], cerr)
            aerr = torch.where(tk, ast[0], aerr)
            qc0 = _take(tk, cst[1], qc0)
            qc1 = _take(tk, cst[2], qc1)
            qa0 = torch.where(tk, ast[1], qa0)
            qa1 = torch.where(tk, ast[2], qa1)
            cidx = torch.where(tk, cst[5], cidx)
            aidx = torch.where(tk, ast[3], aidx)
            err = cerr + aerr
        return (err, cerr, aerr, rot, sel, qc0, qc1, qa0, qa1, cidx, aidx)

    if uber or shake:
        best = refine(best)
        if keep2:
            best = _merge(refine(best2), best)
    return best


def _pack_dual(mode, st):
    """Field 1 drives colour iff sel == 0; each field's anchor fix-up
    complements its indices and swaps the endpoint pair it drives."""
    _, _, _, rot, sel, qc0, qc1, qa0, qa1, cidx, aidx = st
    sel0 = sel == 0
    f1 = torch.where(sel0, cidx, aidx)
    f2 = torch.where(sel0, aidx, cidx)
    for fi, ib in ((1, mode.index_bits), (2, mode.index_bits2)):
        f = f1 if fi == 1 else f2
        need = (f[0:1] & (1 << (ib - 1))) != 0
        f = torch.where(need, ((1 << ib) - 1) - f, f)
        drives_colour = sel0 if fi == 1 else ~sel0
        sw_c, sw_a = need & drives_colour, need & ~drives_colour
        qc0, qc1 = _take(sw_c, qc1, qc0), _take(sw_c, qc0, qc1)
        qa0, qa1 = torch.where(sw_a, qa1, qa0), torch.where(sw_a, qa0, qa1)
        if fi == 1:
            f1 = f
        else:
            f2 = f
    out = Sink(rot.shape, 4, rot.device)
    out.put(torch.full_like(rot, 1 << mode.mode), 0, mode.mode + 1)
    pos = mode.mode + 1
    out.put(rot, pos, 2)
    pos += 2
    if mode.index_mode_bits:
        out.put(sel, pos, 1)
        pos += 1
    for c in range(3):
        out.put(qc0[c], pos, mode.colour_bits)
        out.put(qc1[c], pos + mode.colour_bits, mode.colour_bits)
        pos += 2 * mode.colour_bits
    out.put(qa0, pos, mode.alpha_bits)
    out.put(qa1, pos + mode.alpha_bits, mode.alpha_bits)
    pos += 2 * mode.alpha_bits
    for f, ib in ((f1, mode.index_bits), (f2, mode.index_bits2)):
        for p in range(16):
            nb = ib - (1 if p == 0 else 0)
            out.put(f[p:p + 1], pos, nb)
            pos += nb
    return out.cols


# --------------------------------------------------------- plain versions ---

def _ids_tensor(ids, n, device):
    """A shortlist argument -> (N,K) int32 ids: a tensor as it is, an int K as
    partitions 0..K-1 for every block."""
    if isinstance(ids, int):
        return torch.arange(ids, dtype=I32, device=device).expand(n, ids)
    return ids


def bc7_mode_search_plain(blocks, mode: int, ids=None, *, iters: int,
                          shake: int, uber: int, keep: int = 1, bar=None,
                          out=None):
    """One mode's search: (N,16,4) float blocks in [0,1] -> ((N,4) int32
    words, (N,) float32 error); see ``bc7_mode_search``."""
    m = BC7_MODES[mode]
    x01 = blocks[..., :4].to(F32).permute(2, 1, 0)              # (4,16,N)
    xs = [x01[c] * 255.0 for c in range(4)]
    if m.subsets > 1:
        ids = _ids_tensor(ids, blocks.shape[0], blocks.device)
    if m.mode in (4, 5):
        st = _dual_mode(xs, m, iters, shake, uber, keep)
        err, cols = st[0], _pack_dual(m, st)
    elif m.alpha_bits:
        st = _single_mode(xs, m, ids, iters, shake, uber)
        err, cols = st[0], _pack_single(m, st)
    else:
        st = _single_mode(xs[:3], m, ids, iters, shake, uber)
        err = st[0] + _sum16(_sq(xs[3] - 255.0))
        cols = _pack_single(m, st)
    words = wrap_u32(torch.cat(cols, dim=0).t().contiguous())
    err = err[0]
    if bar is not None:
        words = torch.where(bar[:, None], 0, words)
        err = torch.where(bar, _BIG, err)
    if out is None:
        return words, err
    take = err < out[1]
    out[0].copy_(torch.where(take[:, None], words, out[0]))
    out[1].copy_(torch.where(take, err, out[1]))
    return out


def _encode(blocks, plan, bar, estimate, search):
    """Every enabled mode's search in mode order, each merged into the running
    best; shortlists computed once per configuration."""
    shared = {}
    maskable = any(m < 6 for m in plan.modes)
    out = None
    for mode in plan.modes:
        # modes 6/7 are masked only where a mode 0-5 runs before them, so a
        # masked block always holds that mode's finite error; mode 7's
        # shortlist skips the masked blocks, whose ids the search never reads
        mbar = bar if mode >= 6 and maskable else None
        cfg = plan.shortlists.get(mode)
        ids = cfg
        if isinstance(cfg, dict):
            key = (tuple(sorted(cfg.items())), mbar is not None)
            if key not in shared:
                shared[key] = estimate(blocks, **cfg, bar=mbar)
            ids = shared[key]
        out = search(blocks, mode, ids, iters=plan.iters, shake=plan.shake,
                     uber=plan.uber, keep=plan.keep, bar=mbar, out=out)
    return out


def encode_bc7_blocks_plain(blocks: torch.Tensor, *, quality: float = 1.0,
                            mode_mask: int = 0xFF,
                            colour_restrict: bool = True,
                            alpha_restrict: bool = True,
                            performance: float = 1.0, _plist=None,
                            _topk=None, _shake=None, _uber=None):
    """(N,16,4) float RGBA blocks in [0,1] -> ((N,4) int32 words, (N,)
    float32 error). Runs on whatever device ``blocks`` lies on, shortlists
    included."""
    plan = _plan(quality, mode_mask, performance, _plist, _topk, _shake,
                 _uber)
    x = blocks[..., :4].to(F32)
    bar = _combined_alpha_bar(x, colour_restrict, alpha_restrict)
    return _encode(x, plan, bar, estimate_topk_plain, bc7_mode_search_plain)
