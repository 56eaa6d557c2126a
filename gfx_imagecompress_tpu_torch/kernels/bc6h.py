"""BC6H encoder (signed and unsigned, 14 modes): CUDA kernel and its plain
PyTorch version.

``encode_bc6h_blocks`` is the wrapper the API calls. It turns the float32
pixels into half-float integers (``f32_to_half_int``, torch ops on the
blocks' device) and then runs the search. For a CUDA tensor the search is one
launch of ``csrc/bc6h_kernel.cu`` (over ``csrc/bc6h_search.cuh``), counted in
``LAUNCHES``; for a CPU tensor it is the plain version below. Nothing falls
back from one to the other.

The plain version mirrors the JAX package's Pallas body
(``kernels/bc6h_pallas.py``: ``_bc6h_kernel`` and what it calls) on
``(16, N)`` rows - pixel p of every block in row p - with the same candidate
order (first wins on equality) and the same float32 operation order; sums
over the 16 pixels are a left-to-right chain (``_sum16``), masked sums add
zeros for the pixels outside the subset, roots go through ``sqrt32`` and a
division by a constant divides by a tensor (``div_scalar``). The winner's
precision in the shake is a per-block value that selects over the enabled
precisions, as in the Pallas body.

The search per block (BC6HBlockEncoder::CompressBlock analog):
  - a bounds-axis estimate of the error of each of the 32 two-region shapes
    in the work domain (half-int * 64/31, or 32/31 signed), then the ``topk``
    best shapes, best first;
  - per kept shape: a masked PCA + least-squares fit of each region at the
    3-bit levels; per endpoint precision (the enabled two-region modes grouped
    by their base precision, in mode order): quantise, evaluate the exact
    integer decode palette per region, apply the anchor swaps, and per mode
    the delta-fit gate of the transformed modes;
  - the winner of that race shaken in quantised space (+-1 steps per
    channel), re-swapped, re-gated, kept where strictly better;
  - the one-region race the same way at the 4-bit levels, and its shake;
  - the two-region winner against the one-region winner (the first wins
    ties); where every enabled mode is transformed, a solid-mean candidate
    joins last so that every block has a valid encoding;
  - the winner packed with its mode's bit layout.

Budgets per quality tier (``_budgets``): shapes kept, fit iterations, shake
rounds. The error is the squared distance in half-int space (signed: of the
signed decoded integers).
"""
from __future__ import annotations

import torch

from ..bitpack import Sink, wrap_u32
from ..tables.bc6h_tables import (BC6H_MODES, LAYOUTS, ONE_REGION_INDEX_BIT,
                                  TWO_REGION_INDEX_BIT, TWO_REGION_SHAPE_BIT)
from ..tables.bc7_tables import ANCHOR2, P2, WEIGHTS3, WEIGHTS4
from .bc4 import F32, I32, I64, _max16, _min16, _sum16
from .bc7_est import _chain, div_scalar, sqrt32
from .bc7_fast import _lut

# launches of the CUDA kernel made by the wrapper below
LAUNCHES = {"bc6h": 0}
# the kernel's launch shape (csrc/bc6h_search.cuh; a test holds the two
# together): lanes per block, threads per CTA
BC6H_LANES = 4
BC6H_THREADS = 64

LV3 = tuple(w / 64.0 for w in WEIGHTS3)
LV4 = tuple(w / 64.0 for w in WEIGHTS4)
_EPS = 1e-8
_BIG = 3.4e38
_ANCHOR_CLASSES = (2, 8, 15)
_SHAKE_DELTAS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
                 (1, -1), (1, 0), (1, 1))


# ------------------------------------------------------------- host side ---

def f32_to_half_int(x: torch.Tensor, signed: bool) -> torch.Tensor:
    """float32 -> int32 half representation.

    unsigned: the half bits' magnitude, negatives -> 0; signed: sign *
    magnitude bits. Finite values are clamped to +-65504 first, so the
    magnitude of a number is at most 0x7BFF; a NaN becomes the quiet half NaN
    0x7E00 with its sign, whatever the device's own conversion does with it.
    """
    x = x.to(F32)
    h = x.clamp(-65504.0, 65504.0).to(torch.float16).view(torch.int16)
    h = h.to(I32) & 0xFFFF
    h = torch.where(torch.isnan(x),
                    0x7E00 | (torch.signbit(x).to(I32) << 15), h)
    mag = h & 0x7FFF
    neg = (h & 0x8000) != 0
    if signed:
        return torch.where(neg, -mag, mag)
    return torch.where(neg, 0, mag)


def _to_work(h: torch.Tensor, signed: bool) -> torch.Tensor:
    """half-int -> float work domain (inverse of finish: * 64/31 or 32/31)."""
    hf = h.to(F32)
    return hf * torch.full_like(hf, (32.0 if signed else 64.0) / 31.0)


def _budgets(quality: float):
    """quality -> (shapes kept, fit iterations, shake rounds); the JAX
    entry's tiers."""
    if quality <= 0.3:
        return 2, 1, 0
    if quality <= 0.7:
        return 3, 2, 0
    if quality <= 0.8:
        return 4, 2, 0
    return 4, 2, 1


def _enabled(mode_mask: int, regions: int):
    """(mode index, mode) of the enabled modes of one region count, in mode
    order."""
    return [(mi, m) for mi, m in enumerate(BC6H_MODES)
            if m.regions == regions and (mode_mask >> (m.mode - 1)) & 1]


def fallback_mode(mode_mask: int):
    """The mode index of the solid-mean fallback, or None: it exists only
    when every enabled mode is transformed, and takes the first enabled
    one-region mode, else the first enabled two-region mode."""
    two, one = _enabled(mode_mask, 2), _enabled(mode_mask, 1)
    if (two or one) and all(m.transformed for _, m in two + one):
        return (one or two)[0][0]
    return None


# ---------------------------------------------------------- quantisation ---

def _quantize(u, prec: int, signed: bool):
    """Work-domain float endpoint -> prec-bit field value."""
    if not signed:
        uq = torch.clamp(torch.round(u), 0, 0xFFFF).to(I32)
        if prec >= 15:
            return torch.clamp(uq, 0, (1 << prec) - 1)
        return torch.clamp((uq * (1 << prec) + 0x8000) >> 16, 0,
                           (1 << prec) - 1)
    uq = torch.clamp(torch.round(u), -0x7FFF, 0x7FFF).to(I32)
    if prec >= 16:
        return uq
    mx = (1 << (prec - 1)) - 1
    mag = uq.abs()
    q = torch.clamp((mag * (1 << (prec - 1)) + 0x4000) >> 15, 0, mx)
    return torch.where(uq < 0, -q, q)


def _unquantize(q, prec: int, signed: bool):
    if not signed:
        if prec >= 15:
            return q
        maxq = (1 << prec) - 1
        u = ((q << 16) + 0x8000) >> prec
        u = torch.where(q == 0, 0, u)
        return torch.where(q == maxq, 0xFFFF, u)
    if prec >= 16:
        return q
    a = q.abs()
    maxa = (1 << (prec - 1)) - 1
    u = ((a << 15) + 0x4000) >> (prec - 1)
    u = torch.where(a == 0, 0, u)
    u = torch.where(a >= maxa, 0x7FFF, u)
    return torch.where(q < 0, -u, u)


def _unquantize_dyn(q, prec_rows, signed, precs):
    """Unquantise with a per-block precision (select over the static set)."""
    out = None
    for p in precs:
        u = _unquantize(q, p, signed)
        out = u if out is None else torch.where(prec_rows == p, u, out)
    return out


def _finish(v, signed: bool):
    """Interpolated value -> the decoded integer the error is measured on:
    unsigned half bits, or the signed decoded int."""
    if not signed:
        return (v * 31) >> 6
    mag = (v.abs() * 31) >> 5
    return torch.where(v < 0, -mag, mag)


def _palette_err_u(h, mask_rows, u0, u1, signed, wtab):
    """Exact decode-path palette evaluation from unquantised endpoints.
    h: 3 (16,N) int32 rows; u0/u1: 3 (1,N) int32. -> (16,N) indices, (1,N)
    masked error sum."""
    best = idx = None
    for k, wk in enumerate(wtab):
        d = None
        for c in range(3):
            v = (u0[c] * (64 - wk) + u1[c] * wk + 32) >> 6
            diff = h[c].to(F32) - _finish(v, signed).to(F32)
            d = diff * diff if d is None else d + diff * diff
        if best is None:
            best, idx = d, torch.zeros_like(d, dtype=I32)
        else:
            take = d < best
            best = torch.where(take, d, best)
            idx = torch.where(take, k, idx)
    if mask_rows is not None:
        best = best * mask_rows
    return idx, _sum16(best)


def _palette_err(h, mask_rows, q0, q1, prec, signed, wtab):
    u0 = [_unquantize(q, prec, signed) for q in q0]
    u1 = [_unquantize(q, prec, signed) for q in q1]
    return _palette_err_u(h, mask_rows, u0, u1, signed, wtab)


# ------------------------------------------------------------ estimation ---

def _estimate_shapes(us):
    """Bounds-axis error estimate of each of the 32 two-region shapes: per
    region, the pixels centred on their mean, projected on the diagonal of
    their bounding box and quantised to 8 levels; the squared distance to
    the axis plus the squared quantisation error, summed in pixel order."""
    ests = []
    for sh in range(32):
        terms = []
        for s in (0, 1):
            rows = [p for p in range(16) if ((P2[sh] >> p) & 1) == s]
            cnt = float(len(rows))
            x = [u[rows] for u in us]                          # (cnt,N)
            mean = [div_scalar(_chain([xc[i:i + 1] for i in range(len(rows))]),
                               cnt) for xc in x]
            cen = [xc - mn for xc, mn in zip(x, mean)]
            axis = [c.amax(0, keepdim=True) - c.amin(0, keepdim=True)
                    for c in cen]
            n = sqrt32(_chain([a * a for a in axis]))
            inv = 1.0 / torch.clamp(n, min=1e-6)
            axis = [a * inv for a in axis]
            ts = _chain([cen[c] * axis[c] for c in range(3)])
            tmin = ts.amin(0, keepdim=True)
            tmax = ts.amax(0, keepdim=True)
            span = torch.clamp(tmax - tmin, min=1e-6)
            tq = torch.round((ts - tmin) / span * 7.0)
            tr = tq * (1.0 / 7.0) * span + tmin
            d2 = _chain([cen[c] * cen[c] for c in range(3)]) - ts * ts
            add = d2 + (ts - tr) * (ts - tr)
            terms += [add[i:i + 1] for i in range(len(rows))]
        ests.append(_chain(terms))
    return ests


def _topk_ids(ests, k):
    """The k shapes of least estimate, best first; the first of equal
    estimates wins."""
    ids = []
    ests = list(ests)
    for _ in range(k):
        best, bid = ests[0], torch.zeros_like(ests[0], dtype=I32)
        for j in range(1, 32):
            take = ests[j] < best
            best = torch.where(take, ests[j], best)
            bid = torch.where(take, j, bid)
        ids.append(bid)
        ests = [torch.where(bid == j, _BIG, ests[j]) for j in range(32)]
    return ids


def _fit_masked(us, m, levels, iters):
    """Masked 3-channel PCA + least-squares fit in the work domain; m is the
    (16,N) 0/1 mask. 8 ones-seeded power rounds; the axis falls back to
    0.57735026 per component where it vanishes; each least-squares round
    assigns every pixel its nearest level (first wins) and solves where the
    determinant is not below 1e-6."""
    cnt = torch.clamp(_sum16(m), min=1.0)
    mean = [_sum16(x * m) / cnt for x in us]
    cen = [(x - mn) * m for x, mn in zip(us, mean)]
    cov = {(a, b): _sum16(cen[a] * cen[b])
           for a in range(3) for b in range(a, 3)}
    v = [torch.ones_like(mean[0]) for _ in range(3)]
    for _ in range(8):
        nv = [_chain([cov[(min(a, b), max(a, b))] * v[b] for b in range(3)])
              for a in range(3)]
        n = sqrt32(_chain([x * x for x in nv]))
        ok = n > _EPS
        inv = 1.0 / torch.clamp(n, min=_EPS)
        v = [torch.where(ok, a * inv, b) for a, b in zip(nv, v)]
    n = sqrt32(_chain([x * x for x in v]))
    ok = n > _EPS
    inv = 1.0 / torch.clamp(n, min=_EPS)
    axis = [torch.where(ok, a * inv, 0.57735026) for a in v]
    t = _chain([c * a for c, a in zip(cen, axis)])
    tmin = _min16(torch.where(m > 0, t, 1e30))
    tmax = _max16(torch.where(m > 0, t, -1e30))
    tmin = torch.where(tmin > tmax, 0.0, tmin)
    tmax = torch.where(tmax < tmin, 0.0, tmax)
    e0 = [mn + tmin * a for mn, a in zip(mean, axis)]
    e1 = [mn + tmax * a for mn, a in zip(mean, axis)]
    for _ in range(iters):
        bestd = alpha = None
        for lv in levels:
            d = None
            for c in range(3):
                diff = us[c] - (e0[c] + lv * (e1[c] - e0[c]))
                d = diff * diff if d is None else d + diff * diff
            if bestd is None:
                bestd, alpha = d, torch.zeros_like(d) + lv
            else:
                take = d < bestd
                bestd = torch.where(take, d, bestd)
                alpha = torch.where(take, lv, alpha)
        one_a = (1.0 - alpha) * m
        a_m = alpha * m
        q00 = _sum16(one_a * (1.0 - alpha))
        q01 = _sum16(one_a * alpha)
        q11 = _sum16(a_m * alpha)
        det = q00 * q11 - q01 * q01
        okd = det.abs() > 1e-6
        invd = 1.0 / torch.where(okd, det, 1.0)
        for c in range(3):
            b0 = _sum16(one_a * us[c])
            b1 = _sum16(a_m * us[c])
            n0 = (q11 * b0 - q01 * b1) * invd
            n1 = (q00 * b1 - q01 * b0) * invd
            e0[c] = torch.where(okd, n0, e0[c])
            e1[c] = torch.where(okd, n1, e1[c])
    return e0, e1


# ------------------------------------------------------ swaps and gates ---

def _delta_ok3(d, bits_tuple):
    ok = None
    for c in range(3):
        b = bits_tuple[c]
        o = (d[c] >= -(1 << (b - 1))) & (d[c] <= (1 << (b - 1)) - 1)
        ok = o if ok is None else ok & o
    return ok


def _swap2(idx, in0, anchor, q):
    """Anchor swaps of a two-region candidate: where pixel 0's index has its
    MSB set, subset 0's indices are complemented and its endpoints swapped;
    then the same for subset 1 at its anchor pixel. in0: (16,N) bool
    (subset-0 membership); q = [e0s0, e1s0, e0s1, e1s1], 3 (1,N) each."""
    need0 = (idx[0:1] & 4) != 0
    idx = torch.where(need0 & in0, 7 - idx, idx)
    q0n = [torch.where(need0, b, a) for a, b in zip(q[0], q[1])]
    q1n = [torch.where(need0, a, b) for a, b in zip(q[0], q[1])]
    a_idx = torch.gather(idx, 0, anchor.to(I64))
    need1 = (a_idx & 4) != 0
    idx = torch.where(need1 & ~in0, 7 - idx, idx)
    q2n = [torch.where(need1, b, a) for a, b in zip(q[2], q[3])]
    q3n = [torch.where(need1, a, b) for a, b in zip(q[2], q[3])]
    return idx, [q0n, q1n, q2n, q3n]


def _swap1(idx, q0, q1):
    """Anchor-pixel-0 swap of a one-region candidate."""
    need = (idx[0:1] & 8) != 0
    idx = torch.where(need, 15 - idx, idx)
    q0n = [torch.where(need, b, a) for a, b in zip(q0, q1)]
    q1n = [torch.where(need, a, b) for a, b in zip(q0, q1)]
    return idx, [q0n, q1n, q0n, q1n]


def _gate(m, qs, err, regions):
    """Delta-fit gate of a transformed mode on swapped endpoints: the error
    becomes 3.4e38 where a delta does not fit its field."""
    if not m.transformed:
        return err
    ok = None
    for j in ((1, 2, 3) if regions == 2 else (1,)):
        o = _delta_ok3([qs[j][c] - qs[0][c] for c in range(3)], m.delta_bits)
        ok = o if ok is None else ok & o
    return torch.where(ok, err, _BIG)


def _merge(best, cand):
    """Keyed on "err", strict <: the incumbent keeps ties."""
    if best is None:
        return cand
    take = cand["err"] < best["err"]
    out = {}
    for k in best:
        if k == "q":
            out["q"] = [[torch.where(take, a, b) for a, b in zip(ca, bb)]
                        for ca, bb in zip(cand["q"], best["q"])]
        else:
            out[k] = torch.where(take, cand[k], best[k])
    return out


def _subset0_rows(shape):
    """(1,N) shape ids -> (16,N) bool, True for the pixels of subset 0."""
    bits = _lut(P2[:32], shape, I64)
    return torch.cat([((bits >> p) & 1) == 0 for p in range(16)], dim=0)


# ----------------------------------------------------------------- shake ---

def _shake_q(h, mask, q0, q1, prec_rows, signed, wtab, idx, rounds, precs):
    """Quantised-space endpoint shaker of one region (ep_shaker_HD
    semantics): per round, the weights of the indices at its start; channel
    by channel, greedily, the 8 steps (+-1, +-1) around the codes, clamped
    to the precision's range; then the region's indices requantised.
    Returns (err, q0, q1, idx)."""
    if signed:
        qlo = _lut([-((1 << (p - 1)) - 1) if p in precs else 0
                    for p in range(32)], prec_rows, I32)
        qhi = -qlo
    else:
        qlo = torch.zeros_like(prec_rows)
        qhi = _lut([(1 << p) - 1 if p in precs else 0 for p in range(32)],
                   prec_rows, I32)
    q0, q1 = list(q0), list(q1)
    err = None
    for _ in range(rounds):
        wk = _lut(wtab, idx, I32)
        for c in range(3):
            def ch_err(a, b, c=c):
                u0 = _unquantize_dyn(a, prec_rows, signed, precs)
                u1 = _unquantize_dyn(b, prec_rows, signed, precs)
                v = (u0 * (64 - wk) + u1 * wk + 32) >> 6
                diff = h[c].to(F32) - _finish(v, signed).to(F32)
                return _sum16(mask * diff * diff)

            best_e, b0, b1 = ch_err(q0[c], q1[c]), q0[c], q1[c]
            for da, db in _SHAKE_DELTAS:
                nq0 = torch.minimum(torch.maximum(q0[c] + da, qlo), qhi)
                nq1 = torch.minimum(torch.maximum(q1[c] + db, qlo), qhi)
                e = ch_err(nq0, nq1)
                take = e < best_e
                best_e = torch.where(take, e, best_e)
                b0 = torch.where(take, nq0, b0)
                b1 = torch.where(take, nq1, b1)
            q0[c], q1[c] = b0, b1
        u0 = [_unquantize_dyn(q, prec_rows, signed, precs) for q in q0]
        u1 = [_unquantize_dyn(q, prec_rows, signed, precs) for q in q1]
        nidx, err = _palette_err_u(h, mask, u0, u1, signed, wtab)
        idx = torch.where(mask > 0, nidx, idx)
    return err, q0, q1, idx


def _shake_best(h, best, modes, signed, rounds, regions):
    """Shake the race winner (its mode, hence its precision, is per-block
    data), re-swap and re-gate, and keep it where strictly better."""
    prec_tab = [0] * len(BC6H_MODES)
    for mi, m in modes:
        prec_tab[mi] = m.base_bits
    prec_rows = _lut(prec_tab, best["mi"], I32)
    precs = tuple(sorted({m.base_bits for _, m in modes}))
    if regions == 2:
        in0 = _subset0_rows(best["shape"])
        m0 = in0.to(F32)
        err0, q0, q1, idx0 = _shake_q(h, m0, best["q"][0], best["q"][1],
                                      prec_rows, signed, WEIGHTS3,
                                      best["idx"], rounds, precs)
        err1, q2, q3, idx1 = _shake_q(h, 1.0 - m0, best["q"][2],
                                      best["q"][3], prec_rows, signed,
                                      WEIGHTS3, best["idx"], rounds, precs)
        err_sh = err0 + err1
        idx_sw, qs_sw = _swap2(torch.where(in0, idx0, idx1), in0,
                               best["anchor"], [q0, q1, q2, q3])
    else:
        ones = torch.ones_like(h[0], dtype=F32)
        err_sh, q0, q1, idx_sh = _shake_q(h, ones, best["q"][0],
                                          best["q"][1], prec_rows, signed,
                                          WEIGHTS4, best["idx"], rounds,
                                          precs)
        idx_sw, qs_sw = _swap1(idx_sh, q0, q1)
    err_g = err_sh
    for mi, m in modes:
        if m.transformed:
            err_g = torch.where(best["mi"] == mi,
                                _gate(m, qs_sw, err_sh, regions), err_g)
    take = err_g < best["err"]
    out = dict(best)
    out["err"] = torch.where(take, err_g, best["err"])
    out["idx"] = torch.where(take, idx_sw, best["idx"])
    out["q"] = [[torch.where(take, a, b) for a, b in zip(qn, qo)]
                for qn, qo in zip(qs_sw, best["q"])]
    return out


# --------------------------------------------------------------- packing ---

def _pack_mode(m, shape, anchor, q, idx):
    """One mode's 4 word columns ((1,N) int64) from swapped endpoints
    q = [w, x, y, z] (3 (1,N) each) and (16,N) indices."""
    pmask = (1 << m.base_bits) - 1
    fields = {}
    for c, ch in enumerate("rgb"):
        fields[ch + "w"] = q[0][c] & pmask
        dmask = (1 << m.delta_bits[c]) - 1
        for j, name in ((1, "x"), (2, "y"), (3, "z")):
            v = q[j][c] - q[0][c] if m.transformed else q[j][c]
            fields[ch + name] = v & dmask
    out = Sink(shape.shape, 4, shape.device)
    out.put(torch.zeros_like(shape) + m.code, 0, m.code_bits)
    for field, src, dst, nbits in LAYOUTS[m.mode]:
        out.put((fields[field] >> src) & ((1 << nbits) - 1), dst, nbits)
    if m.regions == 2:
        out.put(shape, TWO_REGION_SHAPE_BIT, 5)
        z = torch.zeros_like(shape, dtype=I64)
        acc = [z, z, z, z]
        for a in _ANCHOR_CLASSES:
            cls = Sink(shape.shape, 4, shape.device)
            pos = TWO_REGION_INDEX_BIT
            for p in range(16):
                nb = 2 if p in (0, a) else 3
                cls.put(idx[p:p + 1], pos, nb)
                pos += nb
            acc = [torch.where(anchor == a, y, x)
                   for x, y in zip(acc, cls.cols)]
        out.cols = [x | y for x, y in zip(out.cols, acc)]
    else:
        out.put(idx[0:1], ONE_REGION_INDEX_BIT, 3)
        pos = ONE_REGION_INDEX_BIT + 3
        for p in range(1, 16):
            out.put(idx[p:p + 1], pos, 4)
            pos += 4
    return out.cols


# --------------------------------------------------------- plain version ---

def bc6h_search_plain(h: torch.Tensor, *, signed: bool, topk: int, iters: int,
                      shake: int, mode_mask: int):
    """The search on half-ints: (N,16,3) int32 (see ``f32_to_half_int``) ->
    ((N,4) int32 words, (N,) float32 error). Runs on whatever device ``h``
    lies on."""
    ht = h.to(I32).permute(2, 1, 0)                             # (3,16,N)
    hs = [ht[c] for c in range(3)]
    us = [_to_work(x, signed) for x in hs]
    two_modes, one_modes = _enabled(mode_mask, 2), _enabled(mode_mask, 1)
    groups2, groups1 = {}, {}
    for mi, m in two_modes:
        groups2.setdefault(m.base_bits, []).append((mi, m))
    for mi, m in one_modes:
        groups1.setdefault(m.base_bits, []).append((mi, m))
    zero = torch.zeros_like(hs[0][0:1])

    best2 = None
    if two_modes:
        for sid in _topk_ids(_estimate_shapes(us), topk):
            in0 = _subset0_rows(sid)
            anchor = _lut(ANCHOR2[:32], sid, I32)
            m0 = in0.to(F32)
            m1 = 1.0 - m0
            e00, e01 = _fit_masked(us, m0, LV3, iters)
            e10, e11 = _fit_masked(us, m1, LV3, iters)
            for prec, group in groups2.items():
                q = [[_quantize(e[c], prec, signed) for c in range(3)]
                     for e in (e00, e01, e10, e11)]
                idx0, err0 = _palette_err(hs, m0, q[0], q[1], prec, signed,
                                          WEIGHTS3)
                idx1, err1 = _palette_err(hs, m1, q[2], q[3], prec, signed,
                                          WEIGHTS3)
                idx_sw, qs = _swap2(torch.where(in0, idx0, idx1), in0,
                                    anchor, q)
                for mi, m in group:
                    best2 = _merge(best2, dict(
                        err=_gate(m, qs, err0 + err1, 2), mi=zero + mi,
                        shape=sid, anchor=anchor, q=qs, idx=idx_sw))
        if shake:
            best2 = _shake_best(hs, best2, two_modes, signed, shake, 2)

    best1 = None
    if one_modes:
        ones = torch.ones_like(us[0])
        e0, e1 = _fit_masked(us, ones, LV4, iters)
        for prec, group in groups1.items():
            q0 = [_quantize(e0[c], prec, signed) for c in range(3)]
            q1 = [_quantize(e1[c], prec, signed) for c in range(3)]
            idx, err = _palette_err(hs, None, q0, q1, prec, signed, WEIGHTS4)
            idx_sw, qs = _swap1(idx, q0, q1)
            for mi, m in group:
                best1 = _merge(best1, dict(
                    err=_gate(m, qs, err, 1), mi=zero + mi, shape=zero,
                    anchor=zero, q=qs, idx=idx_sw))
        if shake:
            best1 = _shake_best(hs, best1, one_modes, signed, shake, 1)

    best = _merge(best2, best1) if best1 is not None else best2

    fb = fallback_mode(mode_mask)
    if fb is not None:
        m_fb = BC6H_MODES[fb]
        u_mean = [div_scalar(_sum16(u), 16.0) for u in us]
        q_m = [_quantize(u, m_fb.base_bits, signed) for u in u_mean]
        wtab = WEIGHTS4 if m_fb.regions == 1 else WEIGHTS3
        idx_fb, err_fb = _palette_err(hs, None, q_m, q_m, m_fb.base_bits,
                                      signed, wtab)
        best = _merge(best, dict(
            err=err_fb, mi=zero + fb, shape=zero,
            anchor=zero + (ANCHOR2[0] if m_fb.regions == 2 else 0),
            q=[q_m, q_m, q_m, q_m], idx=torch.zeros_like(idx_fb)))

    cols = [torch.zeros_like(best["err"], dtype=I64)] * 4
    for mi, m in two_modes + one_modes:
        cm = _pack_mode(m, best["shape"], best["anchor"], best["q"],
                        best["idx"])
        cols = [torch.where(best["mi"] == mi, b, a) for a, b in zip(cols, cm)]
    words = wrap_u32(torch.cat(cols, dim=0).t().contiguous())
    return words, best["err"][0]


def _check_mask(mode_mask: int, name: str):
    if not mode_mask & 0x3FFF:
        raise ValueError(f"{name}: mode_mask {mode_mask:#x} enables no mode "
                         "of 1..14")


def encode_bc6h_blocks_plain(blocks: torch.Tensor, *, signed: bool = False,
                             mode_mask: int = 0xFFFF, quality: float = 1.0):
    """(N,16,3) float32 HDR blocks -> ((N,4) int32 words, (N,) float32
    error), on whatever device ``blocks`` lies on."""
    _check_mask(mode_mask, "encode_bc6h_blocks_plain")
    topk, iters, shake = _budgets(quality)
    return bc6h_search_plain(f32_to_half_int(blocks[..., :3], signed),
                             signed=signed, topk=topk, iters=iters,
                             shake=shake, mode_mask=mode_mask)


# ------------------------------------------------------------- wrappers ---

def bc6h_search(h: torch.Tensor, *, signed: bool, topk: int, iters: int,
                shake: int, mode_mask: int):
    """The search alone on (N,16,3) int32 half-ints -> ((N,4) int32 words,
    (N,) float32 error): one launch on a CUDA tensor, the plain version on a
    CPU tensor."""
    if h.ndim != 3 or h.shape[1:] != (16, 3):
        raise ValueError("bc6h_search: expected (N,16,3) half-ints, got "
                         f"{tuple(h.shape)}")
    _check_mask(mode_mask, "bc6h_search")
    if not 1 <= topk <= 32 or iters < 0 or shake < 0:
        raise ValueError("bc6h_search: topk 1..32, iters >= 0, shake >= 0")
    if h.device.type == "cpu":
        return bc6h_search_plain(h, signed=signed, topk=topk, iters=iters,
                                 shake=shake, mode_mask=mode_mask)
    if h.device.type != "cuda":
        raise RuntimeError(f"bc6h_search: unsupported device {h.device}")
    if h.dtype != I32 or not h.is_contiguous():
        raise ValueError("bc6h_search: the CUDA kernel takes contiguous int32 "
                         f"half-ints, got {h.dtype}")
    from . import _build
    n = h.shape[0]
    fb = fallback_mode(mode_mask)
    words = torch.empty((n, 4), dtype=I32, device=h.device)
    err = torch.empty((n,), dtype=F32, device=h.device)
    if n:
        with torch.cuda.device(h.device):
            _build.launch("bc6h_encode", h, n, int(bool(signed)), int(topk),
                          int(iters), int(shake), int(mode_mask) & 0xFFFF,
                          -1 if fb is None else fb, words, err)
        LAUNCHES["bc6h"] += 1
    return words, err


def encode_bc6h_blocks(blocks: torch.Tensor, *, signed: bool = False,
                       mode_mask: int = 0xFFFF, quality: float = 1.0):
    """(N,16,3) float32 HDR blocks -> ((N,4) int32 words, (N,) float32
    squared error in half-int space). The half conversion runs as torch ops
    on the blocks' device; on a CUDA tensor the search is one launch.
    ``quality`` picks the budget tier, bits 0-13 of ``mode_mask`` enable
    modes 1-14."""
    if blocks.ndim != 3 or blocks.shape[1] != 16 or blocks.shape[2] < 3:
        raise ValueError("encode_bc6h_blocks: expected (N,16,3) blocks, got "
                         f"{tuple(blocks.shape)}")
    _check_mask(mode_mask, "encode_bc6h_blocks")
    topk, iters, shake = _budgets(quality)
    h = f32_to_half_int(blocks[..., :3], signed).contiguous()
    return bc6h_search(h, signed=signed, topk=topk, iters=iters, shake=shake,
                       mode_mask=mode_mask)
