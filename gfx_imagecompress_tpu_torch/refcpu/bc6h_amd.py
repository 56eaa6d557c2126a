"""Reference-faithful AMD BC6H encoder (CPU, numpy) — quality yardstick.

Re-implements the reference ``BC6HBlockEncoder`` search exactly
(/root/reference/src/amd_bc6h_body.cpp):

* float->half-bit-space conversion incl. the signed handling (:1539-1573),
* shape search: 1-region then all 32 2-region shapes via ``FindBestPattern``
  (:904-1037) with ``optQuantAnD_f`` (amd_hdr_encode.cpp:1427-1601,
  maxTry = 4000*quality) per subset, ``GetEndPoints`` (hdr:1116-1160),
  ``clampF16Max`` (:510-529) and the L1 ``CalcShapeError`` (:783-836,
  including its early-break palette scan),
* the USE_SHAKERHD pass (enabled in the reference, :960-1026) via
  ``ep_shaker_HD`` (hdr:2280-2600): +-1 Gray-code corner sweep, maxTry=1.
  NOTE the reference indexes its 256-entry float ramp with unclamped
  half-space endpoint estimates (hdr:2450-2473) — an out-of-bounds read for
  HDR-range data; here the indices are clamped to [0,255] (same candidates
  where the reference is well-defined, no UB).  Its winning path also stores
  ramp *code* integers as half values (bc6h:1019-1021), so it essentially
  never survives the error gate,
* ``EncodePattern`` (:1351-1488): per candidate mode
  ``QuantizeEndPointToF16Prec`` -> ``SwapIndices`` (fixup MSB constraint)
  -> ``TransformEndPoints`` delta transform + ``isOverflow`` ->
  ``endpts_fit`` losslessness gate -> ``decompress_endpoints1/2`` (with the
  reference's unsigned-flag quirks kept) -> ``palitizeEndPointsF`` ->
  ``ReIndexShapef`` -> ``CalcShapeError``, keeping the best mode; the
  one-region ``CalcOneRegionEndPtsError`` tie-in including its |a-a|=0 term
  (:760-781) is replicated,
* ``SaveDataBlock`` bit packing via the repo's data-driven mode layouts
  (tables/bc6h_tables.py, same data as bc6h:125-417), solid-red fallback
  block ``Cmp_Red_Block`` (:118).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..tables.bc6h_tables import (BC6H_MODES, LAYOUTS, ONE_REGION_INDEX_BIT,
                                  TWO_REGION_INDEX_BIT, TWO_REGION_SHAPE_BIT)
from ..tables.bc7_tables import partition_table
from . import bc7_amd

F16MAX = 0x7BFF
F16HMAX = 0x7BFF
_W3 = np.array([0, 9, 18, 27, 37, 46, 55, 64], np.int64)
_W4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64],
               np.int64)

# position of subset-1's anchor pixel within subset-1's compacted entry list
# (amd_bc6h_body.hpp:194-208)
_REGION2_FIXUP = (7, 3, 11, 7, 3, 11, 9, 5, 2, 12, 7, 3, 11, 7, 11, 3,
                  7, 1, 0, 1, 0, 1, 0, 7, 0, 1, 1, 0, 4, 4, 1, 0)
# anchor pixel of subset 1 (amd_bc6h_body.hpp:210-220)
_INDEX_FIXUPS = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                 15, 15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2)

_RED_BLOCK = np.frombuffer(
    bytes([0xC2, 0x7B] + [0] * 7 + [0xE0, 0x03] + [0] * 5), np.uint8)

_MODE = {m.mode: m for m in BC6H_MODES}
_MODE_FIT_ORDER = tuple(range(15))      # ModeFitOrder is identity (bc6h:1330)


def _f32_to_half_bits(v: float) -> int:
    return int(np.float32(v).astype(np.float16).view(np.uint16))


def _din_from_floats(in_rgb: np.ndarray, signed: bool) -> np.ndarray:
    """float RGB -> half-bit work values (bc6h:1539-1573)."""
    din = np.zeros((16, 3), np.float32)
    for i in range(16):
        for c in range(3):
            v = float(in_rgb[i, c])
            if v < 0.00001:
                din[i, c] = -float(_f32_to_half_bits(abs(v))) if signed \
                    else 0.0
            else:
                din[i, c] = float(_f32_to_half_bits(v))
    return din


def _eigen_f(cov):
    return bc7_amd._eigen_dominant(cov.astype(np.float64))


def _quant_and_shell_f(v, k):
    if len(v) < 2:
        return np.zeros(len(v), np.int64)
    return bc7_amd._quant_and_shell(v.astype(np.float64), k)


def _opt_quant_and_f(data: np.ndarray, num_clusters: int, quality: float):
    """optQuantAnD_f (amd_hdr_encode.cpp:1427-1601): float mirror of the
    BC7 AnD quantizer, maxTry = 4000*quality, no flat-block short-circuit."""
    n, dim = data.shape
    if n == 0:
        return 0.0, np.zeros(0, np.int64), np.zeros((0, dim))
    mean = data.mean(axis=0)
    centered = data - mean
    if n == 1 or (centered == 0).all():
        return 0.0, np.zeros(n, np.int64), np.tile(mean, (n, 1))
    cov = centered.T @ centered
    direction = _eigen_f(cov)
    projected = centered @ direction
    index = np.zeros(n, np.int64)
    snapshot = None
    max_try = int(4000 * quality)
    for i in range(max(max_try, 1)):
        if i:
            try_two = 50
            while True:
                s = index.sum() / n
                t = (index * index).sum() - s * s * n
                direction = centered.T @ index.astype(np.float64)
                q = np.sqrt((direction * direction).sum())
                t = (0.0 if t == 0 else 1.0 / t) * q
                if q != 0:
                    direction = direction / q
                projected = centered @ direction
                order = np.argsort(projected, kind="stable")
                new_index = np.empty(n, np.int64)
                k = 0
                for j in order:
                    while (projected[j] > (k + 0.5 - s) * t
                           and k < num_clusters - 1):
                        k += 1
                    new_index[j] = k
                done = bool((new_index == index).all())
                index = new_index
                try_two -= 1
                if done or try_two < 0:
                    break
            if i == 1:
                snapshot = index.copy()
            elif bool((snapshot == index).all()):
                break
        index = _quant_and_shell_f(projected, num_clusters)
    s = index.sum() / n
    t = (index * index).sum() - s * s * n
    direction = centered.T @ index.astype(np.float64)
    t = 0.0 if t == 0 else 1.0 / t
    out = mean[None, :] + direction[None, :] * (t * (index - s))[:, None]
    return float(((data - out) ** 2).sum()), index, out


def _get_endpoints(outs, counts):
    """GetEndPoints (hdr:1116-1160): min/max by channel sum."""
    eps = []
    for out, cnt in zip(outs, counts):
        if cnt == 0:
            eps.append(np.zeros((2, 3)))
            continue
        sums = out[:cnt].sum(axis=1)
        eps.append(np.stack([out[int(np.argmin(sums))],
                             out[int(np.argmax(sums))]]))
    return eps


def _clamp_f16(eps, signed: bool):
    lo = -F16MAX if signed else 0.0
    return [np.clip(e, lo, F16MAX) for e in eps]


def _lerp_palette(a, b, n):
    """palitizeEndPointsF via lerpf (hdr:66-81, bc6h:707-758)."""
    w = _W4 if n == 16 else _W3
    i = np.arange(n)
    return (a[None, :] * (64 - w[:n, None]) + b[None, :] * w[:n, None]) / 64.0


def _calc_shape_error(din, palettes, sel):
    """CalcShapeError (bc6h:783-836) incl. the early-break scan."""
    total = 0.0
    for i in range(16):
        pal = palettes[sel[i]]
        best = float(np.abs(din[i] - pal[0]).sum())
        for j in range(1, len(pal)):
            if best <= 0:
                break
            e = float(np.abs(din[i] - pal[j]).sum())
            if e <= best:
                best = e
            else:
                break
        total += best
    return total


def _reindex_shape(din, palettes, sel):
    """ReIndexShapef (bc6h:838-902): full palette argmin per pixel."""
    out = [[], []]
    for i in range(16):
        s = int(sel[i])
        d = np.abs(din[i][None, :] - palettes[s]).sum(axis=1)
        out[s].append(int(np.argmin(d)))
    return out


def _quantize_to_int(value: int, prec: int, signed: bool) -> int:
    """QuantizeToInt (hdr:83-114)."""
    if prec <= 1:
        return 0
    neg = False
    value = int(value)
    if signed:
        if value < 0:
            neg = True
            value = -value
        prec -= 1
    else:
        value = max(value, 0)
    bias = (1 << (prec - 11)) - 1 if (prec > 10 and prec != 16) else 0
    bias = 15 if prec == 16 else bias
    q = ((value << prec) + bias) // (F16HMAX + 1)
    return -q if neg else q


def _unquantize(comp: int, bits: int, signed: bool) -> int:
    """Unquantize (hdr:117-150)."""
    if signed:
        if bits >= 16:
            return comp
        s = comp < 0
        c = -comp if s else comp
        if c == 0:
            unq = 0
        elif c >= (1 << (bits - 1)) - 1:
            unq = 0x7FFF
        else:
            unq = ((c << 15) + 0x4000) >> (bits - 1)
        return -unq if s else unq
    if bits >= 15:
        return comp
    if comp == 0:
        return 0
    if comp == (1 << bits) - 1:
        return 0xFFFF
    return ((comp << 16) + 0x8000) >> bits


def _finish_unquantize(q: int, signed: bool) -> int:
    if signed:
        return -(((-q) * 31) >> 5) if q < 0 else (q * 31) >> 5
    return (q * 31) >> 6


def _sign_extend(v: int, bits: int) -> int:
    m = 1 << (bits - 1)
    v = v & ((1 << bits) - 1)
    return (v ^ m) - m


def _is_overflow(v: int, nbit: int) -> bool:
    return not (-(1 << (nbit - 1)) <= v <= (1 << (nbit - 1)) - 1)


def _quantize_endpoints(eps, prec, signed):
    return [np.array([[_quantize_to_int(int(e[ab][c]), prec, signed)
                       for c in range(3)] for ab in range(2)], np.int64)
            for e in eps]


def _swap_indices(ieps, indices, counts, mode, shape):
    """SwapIndices (bc6h:555-581)."""
    m = _MODE[mode]
    ibits = 3 if m.regions == 2 else 4
    nidx = 1 << ibits
    hi = nidx >> 1
    for s in range(m.regions):
        fix = _REGION2_FIXUP[shape] if s else 0
        if counts[s] and indices[s][fix] & hi:
            ieps[s] = ieps[s][::-1].copy()
            for j in range(counts[s]):
                indices[s][j] = nidx - 1 - indices[s][j]


def _transform_endpoints(ieps, mode, nsub):
    """TransformEndPoints (bc6h:598-660); returns None on overflow."""
    m = _MODE[mode]
    out = [np.zeros((2, 3), np.int64) for _ in range(nsub)]
    if m.transformed:
        for i in range(3):
            mask_n = (1 << m.base_bits) - 1
            mask_p = (1 << m.delta_bits[i]) - 1
            out[0][0, i] = ieps[0][0, i] & mask_n
            d = int(ieps[0][1, i] - ieps[0][0, i])
            if _is_overflow(d, m.delta_bits[i]):
                return None
            out[0][1, i] = d & mask_p
            if nsub <= 1 and _is_overflow(out[0][1, i], m.delta_bits[i]):
                return None
            if nsub > 1:
                d = int(ieps[1][0, i] - ieps[0][0, i])
                if _is_overflow(d, m.delta_bits[i]):
                    return None
                out[1][0, i] = d & mask_p
                d = int(ieps[1][1, i] - ieps[0][0, i])
                if _is_overflow(d, m.delta_bits[i]):
                    return None
                out[1][1, i] = d & mask_p
    else:
        for i in range(3):
            out[0][0, i] = ieps[0][0, i] & ((1 << m.base_bits) - 1)
            out[0][1, i] = ieps[0][1, i] & ((1 << m.delta_bits[i]) - 1)
            if nsub > 1:
                out[1][0, i] = ieps[1][0, i] & ((1 << m.delta_bits[i]) - 1)
                out[1][1, i] = ieps[1][1, i] & ((1 << m.delta_bits[i]) - 1)
    return out


def _decompress_endpts_int(comp, mode, nsub, signed):
    """decompress_endpts (bc6h:458-490) — integer code-space roundtrip."""
    m = _MODE[mode]
    out = [np.zeros((2, 3), np.int64) for _ in range(nsub)]
    flat_in = [comp[0][0], comp[0][1]] + (
        [comp[1][0], comp[1][1]] if nsub > 1 else [])
    flat_out = [out[0][0], out[0][1]] + (
        [out[1][0], out[1][1]] if nsub > 1 else [])
    if m.transformed:
        for i in range(3):
            base = int(flat_in[0][i])
            flat_out[0][i] = _sign_extend(base, m.base_bits) if signed \
                else base
            for r in range(1, len(flat_in)):
                t = _sign_extend(int(flat_in[r][i]), m.delta_bits[i])
                t = (t + base) & ((1 << m.base_bits) - 1)
                flat_out[r][i] = _sign_extend(t, m.base_bits) if signed else t
    else:
        for i in range(3):
            flat_out[0][i] = _sign_extend(int(flat_in[0][i]), m.base_bits) \
                if signed else int(flat_in[0][i])
            for r in range(1, len(flat_in)):
                flat_out[r][i] = _sign_extend(int(flat_in[r][i]),
                                              m.delta_bits[i]) if signed \
                    else int(flat_in[r][i])
    return out


def _endpts_fit(orig, comp, mode, nsub, signed) -> bool:
    dec = _decompress_endpts_int(comp, mode, nsub, signed)
    for s in range(nsub):
        if (orig[s] != dec[s]).any():
            return False
    return True


def _decompress_endpoints_f(comp, mode, nsub, signed):
    """decompress_endpoints1/2 (bc6h:1039-1252) with the reference's
    unsigned-flag quirks kept (signed path unquantizes as unsigned)."""
    m = _MODE[mode]
    outf = [np.zeros((2, 3)) for _ in range(nsub)]
    flat_in = [comp[0][0], comp[0][1]] + (
        [comp[1][0], comp[1][1]] if nsub > 1 else [])
    flat_out = [outf[0][0], outf[0][1]] + (
        [outf[1][0], outf[1][1]] if nsub > 1 else [])
    for i in range(3):
        if m.transformed:
            if signed:
                base = _sign_extend(int(flat_in[0][i]), m.base_bits)
            else:
                base = int(flat_in[0][i])
            vals = [base]
            for r in range(1, len(flat_in)):
                t = _sign_extend(int(flat_in[r][i]), m.delta_bits[i])
                t = (t + int(flat_in[0][i])) & ((1 << m.base_bits) - 1)
                vals.append(_sign_extend(t, m.base_bits) if signed else t)
        else:
            if signed:
                vals = [_sign_extend(int(flat_in[0][i]), m.base_bits)]
                vals += [_sign_extend(int(flat_in[r][i]), m.delta_bits[i])
                         for r in range(1, len(flat_in))]
            else:
                vals = [int(f[i]) for f in flat_in]
        for r, v in enumerate(vals):
            u = _unquantize(v, m.base_bits, False)
            flat_out[r][i] = float(_finish_unquantize(u, False))
    return outf


@lru_cache(maxsize=None)
def _rampf(clog: int, bits: int) -> np.ndarray:
    return bc7_amd._ramp(clog, bits)


def _ep_shaker_hd(data, index_in, Mi_, bits, quality_unused=None):
    """ep_shaker_HD (hdr:2280-2600): Gray-code corner sweep, maxTry=1,
    ramp code indices clamped (reference reads OOB for HDR data)."""
    n, dim = data.shape
    clog = max((Mi_ + 1).bit_length() - 1, 1)
    nidx = 1 << clog
    if nidx > 16:
        nidx, clog = 16, 4
    mean = data.mean(axis=0)
    alls = bool((data == data[0]).all())
    index = index_in.copy()
    out_index = index_in.copy()
    epo_code = np.zeros((2, dim), np.int64)
    err_o = np.inf
    nmax = (1 << bits[0]) - 1
    for _ in range(2):
        index = bc7_amd._index_collapse(index)
        Mi = int(index.max())
        if Mi == 0:
            src = data if alls else mean[None, :]
            t, idx1, epo_s = bc7_amd._quant_single_point(
                np.clip(src, 0, 255), Mi_ if Mi_ < 16 else 15,
                [min(b, 8) for b in bits], 0, dim)
            if not alls:
                rb = _rampf(clog, min(bits[0], 8))
                rec = np.array([rb[epo_s[0, j], epo_s[1, j], idx1]
                                for j in range(dim)])
                t = float(((data - rec[None, :]) ** 2).sum())
            if t < err_o:
                out_index = np.full(n, idx1, np.int64)
                epo_code = epo_s
                err_o = t
            return err_o, out_index, epo_code
        err_2 = np.inf
        idx_2 = index.copy()
        epo_2 = np.zeros((2, dim), np.int64)
        p0 = q0 = -1
        rb = _rampf(clog, min(bits[0], 8))
        for q in range(1, Mi_ // Mi + 1):
            for p in range(0, Mi_ - q * Mi + 1):
                cidx = index * q + p
                cc = np.zeros((16, dim))
                cnt = np.zeros(16)
                np.add.at(cc, np.clip(cidx, 0, 15), data)
                np.add.at(cnt, np.clip(cidx, 0, 15), 1.0)
                used = cnt > 0
                cc[used] = np.floor(cc[used] / cnt[used, None] + 0.5)
                w0 = (Mi_ - cidx).astype(np.float64)
                w1 = cidx.astype(np.float64)
                im00, im01 = (w0 * w0).sum(), (w0 * w1).sum()
                im11 = (w1 * w1).sum()
                rp0 = (w0[:, None] * cc[np.clip(cidx, 0, 15)]).sum(axis=0)
                rp1 = (w1[:, None] * cc[np.clip(cidx, 0, 15)]).sum(axis=0)
                dd = im00 * im11 - im01 * im01
                if dd == 0:
                    continue
                epa = np.empty((2, dim))
                epa[0] = (im11 * rp0 - im01 * rp1) / dd * Mi_
                epa[1] = (-im01 * rp0 + im00 * rp1) / dd * Mi_
                # clamped code-space corners (reference: unclamped, OOB)
                epi = np.zeros((2, dim, 2), np.int64)
                for j in range(dim):
                    for i2 in range(2):
                        f = int(np.clip(epa[i2, j], 0, nmax))
                        epi[i2, j, 0] = min(f, 255)
                        epi[i2, j, 1] = min(f + (1 if f < nmax else 0), 255)
                best_err = np.inf
                best_s = 0
                best_idx = None
                for t_step in range(1 << (2 * dim)):
                    s = t_step ^ (t_step >> 1)
                    r = np.stack([
                        rb[epi[0, j, (s >> (2 * j)) & 1],
                           epi[1, j, (s >> (2 * j + 1)) & 1], :nidx]
                        for j in range(dim)])
                    ce = ((r.T[None] - data[:, None, :]) ** 2).sum(axis=2)
                    ci = np.argmin(ce, axis=1)
                    e = float(ce[np.arange(n), ci].sum())
                    if e < best_err:
                        best_err, best_s, best_idx = e, s, ci
                if best_err < err_2:
                    err_2 = best_err
                    idx_2 = best_idx
                    for j in range(dim):
                        epo_2[0, j] = epi[0, j, (best_s >> (2 * j)) & 1]
                        epo_2[1, j] = epi[1, j, (best_s >> (2 * j + 1)) & 1]
                    p0, q0 = p, q
        change = bool((index * q0 + p0 != idx_2).any())
        better = err_2 < err_o
        if better:
            index = idx_2.copy()
            out_index = idx_2.copy()
            epo_code = epo_2
            err_o = err_2
        if not (change and better):
            break
    return err_o, out_index, epo_code


class _ShapeFit:
    __slots__ = ("shape", "nsub", "sel", "counts", "eps", "indices")


def _find_best_pattern(din, two_region: bool, shape: int, quality: float,
                       signed: bool, use_shaker: bool):
    """FindBestPattern (bc6h:904-1037)."""
    nsub = 2 if two_region else 1
    nclusters = 8 if two_region else 16
    sel = (partition_table(2)[shape] if two_region
           else np.zeros(16, np.int64))
    fit = _ShapeFit()
    fit.shape = shape
    fit.nsub = nsub
    fit.sel = sel
    fit.counts = [int((sel == s).sum()) for s in range(nsub)]
    outs = []
    indices = []
    err0 = 0.0
    for s in range(nsub):
        pts = din[sel == s].astype(np.float64)
        e, idx, out = _opt_quant_and_f(pts, nclusters, quality)
        err0 += e
        out_full = np.zeros((16, 3))
        out_full[:len(out)] = out
        outs.append(out_full)
        idx_full = np.zeros(16, np.int64)
        idx_full[:len(idx)] = idx
        indices.append(idx_full)
    best_outs, best_idx = outs, indices
    eps = None
    if use_shaker and nsub > 1 and quality > 0.80:
        err1 = 0.0
        sh_idx = []
        sh_eps = []
        for s in range(nsub):
            pts = din[sel == s].astype(np.float64)
            if len(pts) == 0:
                sh_idx.append(np.zeros(16, np.int64))
                sh_eps.append(np.zeros((2, 3)))
                continue
            e, idx, epo = _ep_shaker_hd(pts, indices[s][:len(pts)].copy(),
                                        len(pts) - 1, [8, 8, 8])
            err1 += e
            idx_full = np.zeros(16, np.int64)
            idx_full[:len(idx)] = idx
            sh_idx.append(idx_full)
            sh_eps.append(np.stack([epo[0, :3], epo[1, :3]]).astype(float))
        if err0 > err1:
            best_idx = sh_idx
            eps = sh_eps           # code-space ints as floats (ref quirk)
    if eps is None:
        eps = _get_endpoints(best_outs, fit.counts)
    eps = _clamp_f16(eps, signed)
    fit.eps = eps
    fit.indices = best_idx
    npal = 16 if nsub == 1 else 8
    palettes = [_lerp_palette(eps[s][0], eps[s][1], npal)
                for s in range(nsub)]
    err = _calc_shape_error(din, palettes, sel)
    return err, fit


def _encode_pattern(din, fit: _ShapeFit, signed: bool):
    """EncodePattern (bc6h:1351-1488).  Returns (mode, quant_eps, indices16)
    or None if no mode fits."""
    nsub = fit.nsub
    min_mode, max_mode = (1, 10) if nsub == 2 else (11, 14)
    npal = 16 if nsub == 1 else 8
    # per-mode saved data (quantEndPoints[modes]/best_Indices[modes]): the
    # reference keeps one slot per mode and saves quantEndPoints[bestFit]
    # at the end (bc6h:1363-1364, 1481), so bestFit's id and data always
    # pair up even when the one-region bestEndpointMode arithmetic picks a
    # mode other than the error-best one.
    saved = {}
    toterr = {}
    best_fit = None
    best_error = np.inf
    best_ep_err = np.inf
    best_ep_mode = 0
    for mode in range(min_mode, max_mode + 1):
        m = _MODE[mode]
        eps = [e.copy() for e in fit.eps]
        # indices in subset-compacted order
        idxs = [fit.indices[s].copy() for s in range(nsub)]
        ieps = _quantize_endpoints(eps, m.base_bits, signed)
        _swap_indices(ieps, idxs, fit.counts, mode, fit.shape)
        q = _transform_endpoints(ieps, mode, nsub)
        if q is None:
            continue
        if not _endpts_fit(ieps, q, mode, nsub, signed):
            continue
        unc = _decompress_endpoints_f(q, mode, nsub, signed)
        palettes = [_lerp_palette(unc[s][0], unc[s][1], npal)
                    for s in range(nsub)]
        if not signed:
            new_idx = _reindex_shape(din, palettes, fit.sel)
            for s in range(nsub):
                for j, v in enumerate(new_idx[s]):
                    idxs[s][j] = v
        err = _calc_shape_error(din, palettes, fit.sel)
        saved[mode] = (q, idxs)
        toterr[mode] = err
        if nsub == 1:
            # CalcOneRegionEndPtsError with its |a-a|=0 bug (bc6h:760-781)
            ep_err = 0.0
            for i in range(16):
                for mm in range(2):
                    for ch in range(3):
                        ep_err += abs(din[i][ch] - unc[0][mm][ch])
            if ep_err < best_ep_err:
                best_ep_err = ep_err
                best_ep_mode = mode
        if err < best_error:
            ok = True
            if not signed:
                # unsigned path requantizes from the decompressed floats
                # (bc6h:1458-1462) into this mode's slot
                ieps2 = _quantize_endpoints(unc, m.base_bits, signed)
                _swap_indices(ieps2, idxs, fit.counts, mode, fit.shape)
                q2 = _transform_endpoints(ieps2, mode, nsub)
                ok = q2 is not None
                if ok:
                    saved[mode] = (q2, idxs)
            if ok:
                if nsub == 1:
                    best_fit = mode if mode == best_ep_mode \
                        else min(mode, best_ep_mode)
                else:
                    best_fit = mode
                best_error = toterr.get(best_fit, err)
    if best_fit is None or best_fit not in saved:
        return None
    mode = best_fit
    q, idxs = saved[best_fit]
    # zip subset indices into block order (SaveCompressedBlockData 691-702)
    pos = [0, 0]
    indices16 = np.zeros(16, np.int64)
    for i in range(16):
        s = int(fit.sel[i])
        indices16[i] = idxs[s][pos[s]]
        pos[s] += 1
    return mode, q, indices16, best_error


class _Bits:
    def __init__(self):
        self.block = bytearray(16)

    def put(self, dst_bit, nbits, val):
        val = int(val) & ((1 << nbits) - 1)
        for k in range(nbits):
            if (val >> k) & 1:
                self.block[(dst_bit + k) >> 3] |= 1 << ((dst_bit + k) & 7)


def _save_data_block(mode, q, indices16, shape, nsub) -> bytes:
    """SaveDataBlock via the data-driven layouts (bc6h:125-454)."""
    m = _MODE[mode]
    fields = {"rw": q[0][0, 0], "gw": q[0][0, 1], "bw": q[0][0, 2],
              "rx": q[0][1, 0], "gx": q[0][1, 1], "bx": q[0][1, 2]}
    if nsub > 1:
        fields.update({"ry": q[1][0, 0], "gy": q[1][0, 1], "by": q[1][0, 2],
                       "rz": q[1][1, 0], "gz": q[1][1, 1], "bz": q[1][1, 2]})
    w = _Bits()
    w.put(0, m.code_bits, m.code)
    for name, src, dst, nb in LAYOUTS[mode]:
        w.put(dst, nb, int(fields[name]) >> src)
    if nsub > 1:
        w.put(TWO_REGION_SHAPE_BIT, 5, shape)
        bit = TWO_REGION_INDEX_BIT
        nb = 2
        w.put(bit, nb, indices16[0])
        for i in range(1, 16):
            bit += nb
            nb = 2 if _INDEX_FIXUPS[shape] == i else 3
            w.put(bit, nb, indices16[i])
    else:
        w.put(ONE_REGION_INDEX_BIT, 3, indices16[0])
        bit = ONE_REGION_INDEX_BIT + 3
        for i in range(1, 16):
            w.put(bit, 4, indices16[i])
            bit += 4
    return bytes(w.block)


def compress_block(rgb: np.ndarray, signed: bool = False,
                   quality: float = 1.0) -> bytes:
    """BC6HBlockEncoder::CompressBlock (bc6h:1521-1651).

    rgb: (16, 3) float32 linear values ([0,1]-ish for unsigned)."""
    din = _din_from_floats(np.asarray(rgb, np.float32), signed)
    best_err = np.inf
    best_fit = None
    err, fit = _find_best_pattern(din, False, 0, quality, signed, True)
    if err < best_err:
        best_err, best_fit = err, fit
    for shape in range(32):
        err, fit = _find_best_pattern(din, True, shape, quality, signed,
                                      True)
        if err < best_err:
            best_err, best_fit = err, fit
    res = _encode_pattern(din, best_fit, signed)
    if res is None:
        return bytes(_RED_BLOCK)
    mode, q, indices16, _ = res
    return _save_data_block(mode, q, indices16, best_fit.shape,
                            best_fit.nsub)


def encode_blocks(blocks_rgb: np.ndarray, signed: bool = False,
                  quality: float = 1.0) -> np.ndarray:
    """(N,16,3) float RGB -> (N,4) uint32 BC6H words."""
    out = np.empty((len(blocks_rgb), 16), np.uint8)
    for i in range(len(blocks_rgb)):
        out[i] = np.frombuffer(
            compress_block(blocks_rgb[i], signed, quality), np.uint8)
    return out.view("<u4").reshape(-1, 4)
