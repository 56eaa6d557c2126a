"""Reference-faithful bc7enc16 fast BC7 encoder (CPU, numpy) — quality yardstick.

Re-implements Richard Geldreich's bc7enc16 exactly as the reference ships it
(/root/reference/src/richgel999_bc7enc16.cpp): modes 1+6 only,

* mode-1 optimal single-colour endpoint table (:162-196) and all-same fast
  path ``pack_mode1_to_one_color`` (:357-404),
* PCA (3-step covariance power iteration for RGB :794-832, incremental for
  RGBA :771-791), projection bounds endpoints,
* ``find_optimal_solution`` explicit p-bit quantization math (:606-729),
  ``fixDegenerateEndpoints`` (:574-604),
* ``evaluate_solution`` exact selector fit (:405-572) with the integer YCbCr
  perceptual metric (:325-349),
* least-squares endpoint refit from selectors (:197-289),
* uber levels: selector +-1 perturbation refits (:896-974) and
  selector-scaling extrapolation for uber>=2 (:976-1006),
* mode-1 mean-colour fallback (:1009-1021),
* partition estimation with sorted order + filterbank predictors
  (:1026-1281), and the bit packer (:1283-1388).

Driver semantics (richgel999_bc7enc16.cpp:73-97): uber=4 unless fast (then
0), filterbank always on, try_least_squares always on, perceptual selects
the YCbCr metric + (128,64,16,32) weights scaled at :1524-1533.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..tables.bc7_tables import P2, ANCHOR2

_W3 = np.array([0, 9, 18, 27, 37, 46, 55, 64], np.int64)
_W4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64],
               np.int64)
_MODE1_OPT_INDEX = 2

_SORTED_PARTITION_ORDER = (
    0, 13, 1, 2, 15, 14, 10, 16, 3, 23, 26, 6, 7, 21, 19, 29,
    8, 4, 9, 20, 5, 31, 22, 17, 18, 11, 12, 30, 24, 25, 28, 27,
    32, 33, 34, 45, 46, 51, 49, 50, 48, 38, 39, 37, 53, 52, 54, 36,
    57, 58, 55, 41, 40, 42, 43, 59, 44, 56, 47, 35, 60, 63, 62, 61)

_U32MAX = 0xFFFFFFFF
_PARTITION_PREDICTORS = (
    _U32MAX, _U32MAX, _U32MAX, _U32MAX, _U32MAX,
    (1 << 1) | (1 << 2) | (1 << 8),
    (1 << 1) | (1 << 3) | (1 << 7),
    _U32MAX, _U32MAX,
    (1 << 2) | (1 << 8) | (1 << 16),
    (1 << 7) | (1 << 3) | (1 << 15),
    _U32MAX,
    (1 << 8) | (1 << 14) | (1 << 16),
    (1 << 7) | (1 << 14) | (1 << 15),
    _U32MAX, _U32MAX, _U32MAX, _U32MAX,
    (1 << 14) | (1 << 15),
    (1 << 16) | (1 << 22) | (1 << 14),
    (1 << 17) | (1 << 24) | (1 << 14),
    (1 << 2) | (1 << 14) | (1 << 15) | (1 << 1),
    _U32MAX,
    (1 << 1) | (1 << 3) | (1 << 14) | (1 << 16) | (1 << 22),
    _U32MAX,
    (1 << 1) | (1 << 2) | (1 << 15) | (1 << 17) | (1 << 24),
    (1 << 1) | (1 << 3) | (1 << 22),
    _U32MAX, _U32MAX, _U32MAX,
    (1 << 14) | (1 << 15) | (1 << 16) | (1 << 17),
    _U32MAX, _U32MAX,
    (1 << 1) | (1 << 2) | (1 << 3) | (1 << 27) | (1 << 4) | (1 << 24),
    (1 << 14) | (1 << 15) | (1 << 16) | (1 << 11) | (1 << 17) | (1 << 27))


@lru_cache(maxsize=1)
def _partition2() -> np.ndarray:
    out = np.zeros((64, 16), np.int64)
    for p, packed in enumerate(P2):
        for i in range(16):
            out[p, i] = (packed >> i) & 1
    return out


@lru_cache(maxsize=1)
def _mode1_optimal_endpoints():
    """g_bc7_mode_1_optimal_endpoints (richgel:162-196), vectorized."""
    l = np.arange(64)
    low = (((l[:, None] << 1) | np.array([0, 1])[None, :]) << 1)
    low = low | (low >> 7)                       # (64, 2) decoded low
    k = (low[:, None, :] * (64 - _W3[_MODE1_OPT_INDEX])
         + low[None, :, :] * _W3[_MODE1_OPT_INDEX] + 32) >> 6   # (l, h, p)
    c = np.arange(256)[:, None, None, None]
    err = (k[None] - c) ** 2                     # (256, 64, 64, 2)
    flat = err.transpose(0, 3, 1, 2).reshape(256, 2, -1)
    best = flat.argmin(axis=2)
    return best // 64, best % 64, flat.min(axis=2)   # lo, hi, err


def _weightsx(weights):
    w = weights / 64.0
    return np.stack([w * w, (1 - w) * w, (1 - w) * (1 - w), w],
                    axis=1).astype(np.float32)


def _dist(e1, pix, perceptual, weights, has_alpha):
    """compute_color_distance_rgb(a) (richgel:325-355).

    e1: (M,4) int, pix: (N,4) int -> (M,N) int error matrix."""
    e1 = e1.astype(np.int64)
    pix = pix.astype(np.int64)
    if perceptual:
        l1 = e1[:, 0] * 109 + e1[:, 1] * 366 + e1[:, 2] * 37
        cr1 = (e1[:, 0] << 9) - l1
        cb1 = (e1[:, 2] << 9) - l1
        l2 = pix[:, 0] * 109 + pix[:, 1] * 366 + pix[:, 2] * 37
        cr2 = (pix[:, 0] << 9) - l2
        cb2 = (pix[:, 2] << 9) - l2
        dr = (l1[:, None] - l2[None, :]) >> 8
        dg = (cr1[:, None] - cr2[None, :]) >> 8
        db = (cb1[:, None] - cb2[None, :]) >> 8
    else:
        dr = e1[:, 0][:, None] - pix[:, 0][None, :]
        dg = e1[:, 1][:, None] - pix[:, 1][None, :]
        db = e1[:, 2][:, None] - pix[:, 2][None, :]
    err = (weights[0] * dr * dr + weights[1] * dg * dg
           + weights[2] * db * db)
    if has_alpha:
        da = e1[:, 3][:, None] - pix[:, 3][None, :]
        err = err + weights[3] * da * da
    return err


class _Params:
    def __init__(self, pixels, weights, perceptual, comp_bits, nweights,
                 has_pbits, share_pbit, has_alpha):
        self.pixels = pixels            # (N,4) uint8 as int64
        self.weights = weights
        self.perceptual = perceptual
        self.comp_bits = comp_bits
        self.sel_weights = _W3 if nweights == 8 else _W4
        self.sel_weightsx = _weightsx(self.sel_weights)
        self.nweights = nweights
        self.has_pbits = has_pbits
        self.share_pbit = share_pbit
        self.has_alpha = has_alpha


class _Results:
    def __init__(self, n):
        self.err = np.inf
        self.low = np.zeros(4, np.int64)
        self.high = np.zeros(4, np.int64)
        self.pbits = [0, 0]
        self.selectors = np.zeros(n, np.int64)


def _scale_color(c, p: _Params):
    n = p.comp_bits + (1 if p.has_pbits else 0)
    v = c.astype(np.int64) << (8 - n)
    return v | (v >> n)


def _evaluate_solution(low, high, pbits, p: _Params, r: _Results):
    """evaluate_solution (richgel:405-572)."""
    if p.has_pbits:
        minp = pbits[0]
        maxp = pbits[0] if p.share_pbit else pbits[1]
        qmin = (low << 1) | minp
        qmax = (high << 1) | maxp
    else:
        qmin, qmax = low, high
    amin = _scale_color(qmin, p)
    amax = _scale_color(qmax, p)
    N = p.nweights
    nc = 4 if p.has_alpha else 3
    wc = np.tile(amin, (N, 1))
    wc[N - 1] = amax
    for i in range(1, N - 1):
        wc[i, :nc] = (amin[:nc] * (64 - p.sel_weights[i])
                      + amax[:nc] * p.sel_weights[i] + 32) >> 6
    pix = p.pixels
    npix = len(pix)
    if not p.perceptual:
        delta = (amax[:nc] - amin[:nc]).astype(np.float64)
        f = N / float((delta * delta).sum() + .00000125)
        proj = ((pix[:, :nc] - amin[None, :nc]) * delta[None, :]).sum(axis=1)
        sel = (proj.astype(np.float64) * f + 0.5).astype(np.int64)
        sel = np.clip(sel, 1, N - 1)
        d = _dist(wc, pix, False, p.weights, p.has_alpha)
        err0 = d[sel - 1, np.arange(npix)]
        err1 = d[sel, np.arange(npix)]
        best_sel = np.where(err0 < err1, sel - 1, sel)
        # reference keeps err1 on ties for alpha path, err1 unless err0<err1:
        total = int(np.minimum(err0, err1).sum())
        sels = best_sel
    else:
        d = _dist(wc, pix, True, p.weights, p.has_alpha)
        sels = np.argmin(d, axis=0)
        total = int(d[sels, np.arange(npix)].sum())
    if total < r.err:
        r.err = total
        r.low = low.copy()
        r.high = high.copy()
        r.pbits = [pbits[0], pbits[1]]
        r.selectors = sels.astype(np.int64)
    return total


def _fix_degenerate(mode, tmin, tmax, xl, xh, iscale):
    """fixDegenerateEndpoints (richgel:574-604)."""
    if mode != 1:
        return
    for i in range(3):
        if tmin[i] == tmax[i] and abs(xl[i] - xh[i]) > 0.0:
            if tmin[i] > (iscale >> 1):
                if tmin[i] > 0:
                    tmin[i] -= 1
                elif tmax[i] < iscale:
                    tmax[i] += 1
            else:
                if tmax[i] < iscale:
                    tmax[i] += 1
                elif tmin[i] > 0:
                    tmin[i] -= 1


def _find_optimal_solution(mode, xl, xh, p: _Params, r: _Results):
    """find_optimal_solution (richgel:606-729)."""
    xl = np.clip(xl, 0.0, 1.0)
    xh = np.clip(xh, 0.0, 1.0)
    if p.has_pbits:
        iscalep = (1 << (p.comp_bits + 1)) - 1
        scalep = float(iscalep)
        ncomp = 4 if p.has_alpha else 3
        if not p.share_pbit:
            best = [None, None]
            for pb in range(2):
                xmin = np.clip(((xl * scalep - pb) / 2.0 + 0.5).astype(
                    np.int64) * 2 + pb, pb, iscalep - 1 + pb)
                xmax = np.clip(((xh * scalep - pb) / 2.0 + 0.5).astype(
                    np.int64) * 2 + pb, pb, iscalep - 1 + pb)
                sl = _scale_color(xmin, p).astype(np.float64)
                sh = _scale_color(xmax, p).astype(np.float64)
                e0 = ((sl[:ncomp] - xl[:ncomp] * 255.0) ** 2).sum()
                e1 = ((sh[:ncomp] - xh[:ncomp] * 255.0) ** 2).sum()
                if best[0] is None or e0 < best[0][0]:
                    best[0] = (e0, pb, xmin >> 1)
                if best[1] is None or e1 < best[1][0]:
                    best[1] = (e1, pb, xmax >> 1)
            pbits = [best[0][1], best[1][1]]
            bmin, bmax = best[0][2].copy(), best[1][2].copy()
        else:
            bb = None
            for pb in range(2):
                xmin = np.clip(((xl * scalep - pb) / 2.0 + 0.5).astype(
                    np.int64) * 2 + pb, pb, iscalep - 1 + pb)
                xmax = np.clip(((xh * scalep - pb) / 2.0 + 0.5).astype(
                    np.int64) * 2 + pb, pb, iscalep - 1 + pb)
                sl = _scale_color(xmin, p).astype(np.float64) / 255.0
                sh = _scale_color(xmax, p).astype(np.float64) / 255.0
                e = (((sl[:ncomp] - xl[:ncomp]) ** 2).sum()
                     + ((sh[:ncomp] - xh[:ncomp]) ** 2).sum())
                if bb is None or e < bb[0]:
                    bb = (e, pb, xmin >> 1, xmax >> 1)
            pbits = [bb[1], bb[1]]
            bmin, bmax = bb[2].copy(), bb[3].copy()
        _fix_degenerate(mode, bmin, bmax, xl, xh, iscalep >> 1)
        if (r.err == np.inf or (bmin != r.low).any() or (bmax != r.high).any()
                or pbits[0] != r.pbits[0] or pbits[1] != r.pbits[1]):
            _evaluate_solution(bmin, bmax, pbits, p, r)
    else:
        iscale = (1 << p.comp_bits) - 1
        tmin = np.clip((xl * iscale + 0.5).astype(np.int64), 0, 255)
        tmax = np.clip((xh * iscale + 0.5).astype(np.int64), 0, 255)
        _fix_degenerate(mode, tmin, tmax, xl, xh, iscale)
        if (r.err == np.inf or (tmin != r.low).any()
                or (tmax != r.high).any()):
            _evaluate_solution(tmin, tmax, r.pbits, p, r)
    return r.err


def _lsq_endpoints(selectors, wx, pixels, has_alpha):
    """compute_least_squares_endpoints_rgb(a) (richgel:197-289)."""
    w = wx[selectors]
    z00 = w[:, 0].sum()
    z10 = w[:, 1].sum()
    z11 = w[:, 2].sum()
    z01 = z10
    nc = 4 if has_alpha else 3
    q00 = (w[:, 3][:, None] * pixels[:, :nc]).sum(axis=0)
    t = pixels[:, :nc].sum(axis=0).astype(np.float64)
    q10 = t - q00
    det = z00 * z11 - z01 * z10
    det = 1.0 / det if det != 0.0 else det
    xl = np.full(4, 255.0)
    xh = np.full(4, 255.0)
    xl[:nc] = (z11 * det) * q00 + (-z01 * det) * q10
    xh[:nc] = (-z10 * det) * q00 + (z00 * det) * q10
    return xl, xh


def _pack_mode1_one_color(p: _Params, r: _Results, rgb):
    """pack_mode1_to_one_color (richgel:357-404)."""
    lo_t, hi_t, err_t = _mode1_optimal_endpoints()
    best_p = 0 if (err_t[rgb[0], 0] + err_t[rgb[1], 0] + err_t[rgb[2], 0]
                   <= err_t[rgb[0], 1] + err_t[rgb[1], 1]
                   + err_t[rgb[2], 1]) else 1
    low = np.array([lo_t[rgb[j], best_p] for j in range(3)] + [0], np.int64)
    high = np.array([hi_t[rgb[j], best_p] for j in range(3)] + [0], np.int64)
    dec = np.empty(4, np.int64)
    for j in range(3):
        lo = ((low[j] << 1) | best_p) << 1
        lo |= lo >> 7
        hi = ((high[j] << 1) | best_p) << 1
        hi |= hi >> 7
        dec[j] = (lo * (64 - _W3[_MODE1_OPT_INDEX])
                  + hi * _W3[_MODE1_OPT_INDEX] + 32) >> 6
    dec[3] = 255
    total = int(_dist(dec[None], p.pixels, p.perceptual, p.weights,
                      False).sum())
    r.err = total
    r.low, r.high = low, high
    r.pbits = [best_p, 0]
    r.selectors = np.full(len(p.pixels), _MODE1_OPT_INDEX, np.int64)
    return total


def _color_cell_compression(mode, p: _Params, r: _Results, uber,
                            try_least_squares):
    """color_cell_compression (richgel:731-1024)."""
    if mode == 1 and (p.pixels[:, :3] == p.pixels[0, :3]).all():
        return _pack_mode1_one_color(p, r, p.pixels[0, :3])
    n = len(p.pixels)
    pix = p.pixels.astype(np.float64)
    mean_scaled = pix.mean(axis=0)
    mean01 = np.clip(mean_scaled / 255.0, 0.0, 1.0)
    if p.has_alpha:
        # incremental PCA (richgel:771-791)
        axis = np.zeros(4)
        for i in range(n):
            c = pix[i] - mean_scaled
            nvec = axis if i else c
            ln = np.sqrt((nvec * nvec).sum())
            nvec = nvec / ln if ln != 0 else nvec
            axis = axis + c * (c @ nvec)
        ln = np.sqrt((axis * axis).sum())
        axis = axis / ln if ln != 0 else axis
    else:
        d = pix[:, :3] - mean_scaled[None, :3]
        cov = d.T @ d
        v = np.array([0.9, 1.0, 0.7])
        for _ in range(3):
            v2 = cov @ v
            m = np.abs(v2).max()
            if m > 1e-10:
                v2 = v2 / m
            v = v2
        ln = (v * v).sum()
        axis = np.zeros(4)
        if ln >= 1e-10:
            axis[:3] = v / np.sqrt(ln)
    if (axis * axis).sum() < 0.5:
        if p.perceptual:
            axis = np.array([.213, .715, .072, .715 if p.has_alpha else 0.0])
        else:
            axis = np.array([1.0, 1.0, 1.0, 1.0 if p.has_alpha else 0.0])
        axis = axis / np.sqrt((axis * axis).sum())
    proj = (pix - mean_scaled[None]) @ axis
    l, h = proj.min() / 255.0, proj.max() / 255.0
    minc = np.clip(mean01 + axis * l, 0.0, 1.0)
    maxc = np.clip(mean01 + axis * h, 0.0, 1.0)
    if minc.sum() > maxc.sum():
        minc, maxc = maxc, minc
    if not _find_optimal_solution(mode, minc, maxc, p, r):
        return 0
    if try_least_squares:
        xl, xh = _lsq_endpoints(r.selectors, p.sel_weightsx, pix, p.has_alpha)
        if not _find_optimal_solution(mode, xl / 255.0, xh / 255.0, p, r):
            return 0
    if uber > 0:
        base = r.selectors.copy()
        max_sel_v = p.nweights - 1
        mn, mx = int(base.min()), int(base.max())
        variants = [
            np.where((base == mn) & (base < max_sel_v), base + 1, base),
            np.where((base == mx) & (base > 0), base - 1, base),
            np.where((base == mn) & (base < max_sel_v), base + 1,
                     np.where((base == mx) & (base > 0), base - 1, base)),
        ]
        for v in variants:
            xl, xh = _lsq_endpoints(v, p.sel_weightsx, pix, p.has_alpha)
            if not _find_optimal_solution(mode, xl / 255.0, xh / 255.0, p, r):
                return 0
        thresh = (n * 56) >> 4
        if uber >= 2 and r.err > thresh:
            Q = (uber - 2) if uber >= 4 else 1
            for ly in range(-Q, 2):
                for hy in range(max_sel_v - 1, max_sel_v + Q + 1):
                    if ly == 0 and hy == max_sel_v:
                        continue
                    v = np.clip(np.floor(
                        max_sel_v * (base - ly) / (hy - ly) + 0.5),
                        0, max_sel_v).astype(np.int64)
                    xl, xh = _lsq_endpoints(v, p.sel_weightsx, pix,
                                            p.has_alpha)
                    if not _find_optimal_solution(mode, xl / 255.0,
                                                  xh / 255.0, p, r):
                        return 0
    if mode == 1:
        rgb = (mean01 * 255.0 + 0.5).astype(np.int64)
        r2 = _Results(n)
        avg_err = _pack_mode1_one_color(p, r2, rgb)
        if avg_err < r.err:
            r.err = avg_err
            r.low, r.high = r2.low, r2.high
            r.pbits = r2.pbits
            r.selectors = r2.selectors
    return r.err


def _cell_est(pix, perceptual, weights, best_err):
    """color_cell_compression_est (richgel:1026-1162)."""
    if len(pix) == 0:
        return 0
    lo = pix[:, :3].min(axis=0)
    hi = pix[:, :3].max(axis=0)
    wc = np.empty((8, 4), np.int64)
    wc[0, :3] = lo
    wc[7, :3] = hi
    for i in range(1, 7):
        wc[i, :3] = (lo * (64 - _W3[i]) + hi * _W3[i] + 32) >> 6
    wc[:, 3] = 0
    a = (hi - lo).astype(np.int64)
    dots = (wc[:, :3] * a[None]).sum(axis=1)
    thresh = (dots[:-1] + dots[1:] + 1) >> 1
    d = (pix[:, :3].astype(np.int64) * a[None]).sum(axis=1)
    s = np.searchsorted(thresh, d, side="right")
    err = _dist(wc, pix, perceptual, weights, False)
    total = int(err[s, np.arange(len(pix))].sum())
    return total


def _estimate_partition(pixels, max_partitions, filterbank, perceptual,
                        weights):
    """estimate_partition (richgel:1207-1281)."""
    total = min(max_partitions, 64)
    if total <= 1:
        return 0
    p2 = _partition2()
    best_err = np.inf
    best_partition = 0
    best_key = 0
    for it in range(total):
        if best_err <= 0:
            break
        part = _SORTED_PARTITION_ORDER[it]
        if filterbank and 14 <= it <= 34:
            mask = 1 << (best_key + 1)
            if (_PARTITION_PREDICTORS[part] & mask) == 0:
                if it == 34:
                    break
                continue
        sel = p2[part]
        e = 0
        for s in range(2):
            e += _cell_est(pixels[sel == s], perceptual, weights, best_err)
            if e >= best_err:
                break
        if e < best_err:
            best_err = e
            best_partition = part
        if part == 34 and best_partition != 34:
            break
        if it == 13:
            best_key = best_partition
    return best_partition


class _BitSink:
    def __init__(self):
        self.block = bytearray(16)
        self.pos = 0

    def put(self, val, nbits):
        for k in range(nbits):
            if (int(val) >> k) & 1:
                self.block[self.pos >> 3] |= 1 << (self.pos & 7)
            self.pos += 1


def _encode_block(mode, partition, selectors, lows, highs, pbits):
    """encode_bc7_block (richgel:1307-1388)."""
    nsub = 2 if mode == 1 else 1
    part_sel = _partition2()[partition] if nsub == 2 else np.zeros(16,
                                                                   np.int64)
    ibits = 3 if mode == 1 else 4
    nidx = 1 << ibits
    selectors = selectors.copy()
    lows = [x.copy() for x in lows]
    highs = [x.copy() for x in highs]
    pbits = [list(x) for x in pbits]
    anchors = []
    for k in range(nsub):
        anchor = ANCHOR2[partition] if k else 0
        anchors.append(anchor)
        if selectors[anchor] & (nidx >> 1):
            selectors[part_sel == k] = (nidx - 1) - selectors[part_sel == k]
            lows[k], highs[k] = highs[k], lows[k]
            if mode != 1:                       # mode 1 shares p-bits
                pbits[k][0], pbits[k][1] = pbits[k][1], pbits[k][0]
    w = _BitSink()
    w.put(1 << mode, mode + 1)
    if nsub == 2:
        w.put(partition, 6)
    cbits = 6 if mode == 1 else 7
    ncomp = 4 if mode >= 4 else 3
    for comp in range(ncomp):
        for s in range(nsub):
            w.put(int(lows[s][comp]), cbits)
            w.put(int(highs[s][comp]), cbits)
    for s in range(nsub):
        w.put(pbits[s][0], 1)
        if mode != 1:
            w.put(pbits[s][1], 1)
    for i in range(16):
        nb = ibits - 1 if i in anchors else ibits
        w.put(int(selectors[i]), nb)
    return bytes(w.block)


def compress_block(pixels_rgba_u8: np.ndarray, fast: bool = False,
                   perceptual: bool = True) -> bytes:
    """bc7enc16_compress_block via the reference driver's option mapping
    (richgel999_bc7enc16.cpp:73-97)."""
    pix = pixels_rgba_u8.astype(np.int64)
    uber = 0 if fast else 4
    if perceptual:
        pr = (0.5 / (1.0 - 0.2126)) ** 2
        pb = (0.5 / (1.0 - 0.0722)) ** 2
        weights = (int(128 * 4.0), int(64 * 4.0 * pr), int(16 * 4.0 * pb),
                   32 * 4)
    else:
        weights = (1, 1, 1, 1)
    if (pix[:, 3] < 255).any():
        p = _Params(pix, weights, perceptual, 7, 16, True, False, True)
        r = _Results(16)
        _color_cell_compression(6, p, r, uber, True)
        return _encode_block(6, 0, r.selectors, [r.low], [r.high],
                             [(r.pbits[0], r.pbits[1])])
    p = _Params(pix, weights, perceptual, 7, 16, True, False, False)
    r6 = _Results(16)
    best_err = _color_cell_compression(6, p, r6, uber, True)
    best = (6, 0, r6.selectors, [r6.low], [r6.high],
            [(r6.pbits[0], r6.pbits[1])])
    if best_err > 0:
        trial_part = _estimate_partition(pix, 64, True, perceptual, weights)
        sel = _partition2()[trial_part]
        trial_err = 0
        subs = []
        ok = True
        for s in range(2):
            ps = _Params(pix[sel == s], weights, perceptual, 6, 8, True,
                         True, False)
            rs = _Results(int((sel == s).sum()))
            trial_err += _color_cell_compression(1, ps, rs, uber, True)
            subs.append(rs)
            if trial_err > best_err:
                ok = False
                break
        if ok and trial_err < best_err:
            selectors = np.zeros(16, np.int64)
            for s in range(2):
                selectors[sel == s] = subs[s].selectors
            best = (1, trial_part, selectors,
                    [subs[0].low, subs[1].low], [subs[0].high, subs[1].high],
                    [(subs[0].pbits[0], 0), (subs[1].pbits[0], 0)])
    return _encode_block(*best)


def encode_blocks(blocks01: np.ndarray, fast: bool = False,
                  perceptual: bool = True) -> np.ndarray:
    """(N,16,4) float [0,1] blocks -> (N,4) uint32 BC7 words."""
    u8 = np.clip(np.rint(np.asarray(blocks01) * 255.0), 0,
                 255).astype(np.uint8)
    out = np.empty((len(u8), 16), np.uint8)
    for i in range(len(u8)):
        out[i] = np.frombuffer(compress_block(u8[i], fast, perceptual),
                               np.uint8)
    return out.view("<u4").reshape(-1, 4)
