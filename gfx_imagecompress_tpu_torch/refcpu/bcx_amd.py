"""Reference-faithful AMD BCX (BC1-BC5) encoder (CPU, numpy) — quality yardstick.

Re-implements the reference's DXTn optimizer exactly as searched by
``amd_bcx_body.cpp``:

* unique-colour histogram (qsort order: R-major ascending,
  amd_bcx_body.cpp:103-117, 1242-1262),
* ``FindAxis`` PCA-like axis fit with degenerate 1-D/2-D handling
  (amd_bcx_body.cpp:442-570),
* the project -> 8x8 endpoint-pair grid search (``RampSrchW`` :398-435)
  -> index vector -> axis re-fit loop (``CompressRGBBlockX`` :1034-1182),
* 565-grid quantization ``MkRmpOnGrid`` (:122-151),
* per-channel ``Refine`` (:582-806) or full 3-D ``Refine3D`` (:808-932),
* decoder-exact clusterize ``Clstr`` with DXTC index reorder and
  transparent index (:258-378),
* the 1-D scalar path ``CompBlock1``/``Refine1``/``Clstr1``
  (:1372-1868) with the 8-pt vs 6-pt ramp race
  (amd_bcx_helpers.cpp:125-140),
* BC1 3-pt vs 4-pt race + 565 c0/c1 packing (amd_bcx_helpers.cpp:51-105),
  DXT5 alpha index packing (:32-46), explicit 4-bit alpha (:107-123).

float32 arithmetic where the reference uses float, matching its behaviour.
"""
from __future__ import annotations

import numpy as np

F = np.float32

BASE_WEIGHTS = (0.3086, 0.6094, 0.0820)   # block_utils.cpp:164-168

_EPS = (2.0 / 255.0) ** 2
_EPS2 = 3.0 * (2.0 / 255.0) ** 2
_MAX_ERROR = 128000.0
_GBL_SCH_STEP = 0.018
_GBL_SCH_EXT = 0.1
_LCL_SCH_STEP = 0.6
_RND_AMOUNT = (0, 0, 0, 0, 1, 1, 2, 2, 3)   # dwRndAmount, bcx:183
_MV = (0.0, -1.0, 1.0)                       # sMvF[0..2], SCH_STPS=3


def calculate_colour_weightings(block_rgba01: np.ndarray,
                                adaptive: bool) -> np.ndarray:
    """CalculateColourWeightings (block_utils.cpp:162-211), R/G/B order."""
    w = np.array(BASE_WEIGHTS, F)
    if not adaptive:
        return w
    med = block_rgba01[:, :3].mean(axis=0)
    largest = med.max()
    med = med / largest if largest > 0 else np.ones(3, F)
    scale = 1.0 / sum(BASE_WEIGHTS)
    w = w * np.array(BASE_WEIGHTS, F) * scale
    w = (w * 3 * med + w) * 0.25
    return (w / w.sum()).astype(F)


def _unique_colours(pts: np.ndarray):
    """R-major ascending unique rows with repeat counts (bcx:1242-1262)."""
    order = np.lexsort((pts[:, 2], pts[:, 1], pts[:, 0]))
    s = pts[order]
    keep = np.ones(len(s), bool)
    keep[1:] = (s[1:] != s[:-1]).any(axis=1)
    uniq = s[keep]
    idx = np.cumsum(keep) - 1
    rpt = np.bincount(idx, minlength=len(uniq)).astype(F)
    return uniq, rpt


def _find_axis(blk01: np.ndarray, rpt: np.ndarray):
    """FindAxis (bcx:442-570).  blk01: (n,3) in [0,1], R,G,B order mapped to
    the reference's internal (B,G,R) indexing for exactness."""
    b = blk01[:, ::-1]                     # internal ch0=B, ch1=G, ch2=R
    npts = rpt.sum()
    center = (b * rpt[:, None]).sum(axis=0) / npts
    sh = b - center
    rgb2 = (sh * sh * rpt[:, None]).sum(axis=0)
    crrl = np.array([(sh[:, j] * sh[:, (j + 1) % 3] * rpt).sum()
                     for j in range(3)])
    feps = npts * _EPS
    k = int((rgb2 >= feps).sum())
    rgb2 = np.where(rgb2 >= feps, rgb2, 0.0)
    i0 = int(np.argmax(rgb2))
    small = bool((rgb2 < npts * _EPS2).all())
    line = np.zeros(3)
    if small:
        return None, center[::-1], sh[:, ::-1]
    if k == 1:
        line[i0] = 1.0
    elif k == 2:
        i1 = (i0 + 1) % 3 if rgb2[(i0 + 1) % 3] > 0 else (i0 + 2) % 3
        crl = crrl[i0] if i1 == (i0 + 1) % 3 else crrl[(i0 + 2) % 3]
        line[i1] = crl / rgb2[i0]
        line[i0] = 1.0
    else:
        max_det = 100000.0
        for j in range(3):
            det = rgb2[j] * rgb2[(j + 1) % 3] - crrl[j] * crrl[j]
            if max_det < det:
                max_det = det
                i0 = j
        vc1 = np.array([crrl[(i0 + 2) % 3], crrl[(i0 + 1) % 3]])
        m = np.array([[rgb2[(i0 + 1) % 3], -crrl[i0]],
                      [-crrl[i0], rgb2[i0]]])
        vc = m @ vc1 / max_det
        line[i0] = 1.0
        line[(i0 + 1) % 3] = 1.0
        line[(i0 + 2) % 3] = vc[0] + vc[1]
    ln = np.sqrt((line * line).sum())
    line = line / ln if ln > 0 else line * 0.0
    return line[::-1], center[::-1], sh[:, ::-1]   # back to R,G,B order


def _ramp_srch_w(prj, prj_err, rpt, max_err, lo, hi, npoints):
    """RampSrchW (bcx:398-435), vectorized with the same snap rule."""
    step = (hi - lo) / (npoints - 1)
    v = np.floor((prj - lo + step * 0.5) / step) * step + lo
    v = np.where(prj - lo <= 0, lo, np.where(prj - hi >= 0, hi, v))
    err = (rpt * (prj - v) ** 2 + prj_err).sum()
    return min(err, max_err)


def _mk_rmp_on_grid(c: np.ndarray, bits=(5, 6, 5)) -> np.ndarray:
    """MkRmpOnGrid (bcx:122-151).  c: (3,2) R,G,B 0..255 floats."""
    out = np.empty_like(c)
    for j in range(3):
        f1 = float(1 << bits[j])
        f0 = float(1 << (8 - bits[j]))
        for k in range(2):
            v = np.floor(c[j, k])
            if v <= 0.0:
                v = 0.0
            else:
                v += np.floor(128.0 / f1) - np.floor(v / f1)
                v = min(v, 255.0)
            out[j, k] = np.floor(v / f0) * f0
    return out


def _mk_wk_rmp_pts(inp: np.ndarray, bits=(5, 6, 5)):
    """MkWkRmpPts bit-replication (bcx:157-181).  inp: (3,2)."""
    eq = bool((inp[:, 0] == inp[:, 1]).all())
    f = np.array([1 << b for b in bits], float)[:, None]
    out = np.clip(inp + np.floor(inp / f), 0.0, 255.0)
    return eq, out


def _bld_rmp(wk: np.ndarray, npoints: int) -> np.ndarray:
    """BldRmp/BldClrRmp (bcx:188-207).  wk: (3,2) -> (3, npoints)."""
    ramp = np.empty((3, npoints))
    ramp[:, 0] = wk[:, 0]
    ramp[:, npoints - 1] = wk[:, 1]
    for e in range(1, npoints - 1):
        ramp[:, e] = np.floor((wk[:, 0] * (npoints - 1 - e) + wk[:, 1] * e
                               + _RND_AMOUNT[npoints]) / (npoints - 1))
    return ramp


def _clstr_err(blk, rpt, ramp, npoints, eq, weights):
    rl = 1 if eq else npoints
    d = ((blk[:, None, :] - ramp.T[None, :rl, :]) ** 2 * weights).sum(axis=2)
    return (d.min(axis=1) * rpt).sum()


def _refine(inp0, blk, rpt, npoints, weights, steps, bits=(5, 6, 5)):
    """Refine (bcx:582-806): per-channel sequential (2s+1)^2 jitter."""
    fctrs = np.array([1 << (8 - b) for b in bits], float)
    inp = inp0.copy()
    eq, wk = _mk_wk_rmp_pts(inp, bits)
    ramp = _bld_rmp(wk, npoints)
    best_e = _clstr_err(blk, rpt, ramp, npoints, eq, weights)
    if best_e == 0.0 or not steps:
        return best_e, inp
    lo, hi = -min(steps, 8), min(steps, 8)
    for ch in range(3):
        others = [c for c in range(3) if c != ch]
        rmp_err = ((blk[:, None, others] - ramp.T[None, :, others]) ** 2
                   * weights[others]).sum(axis=2)
        bst = inp[ch].copy()
        base = inp0[ch]
        for i in range(lo, hi + 1):
            for j in range(lo, hi + 1):
                inp[ch, 0] = min(max(base[0] + i * fctrs[ch], 0.0), 255.0)
                inp[ch, 1] = min(max(base[1] + j * fctrs[ch], 0.0), 255.0)
                eq, wk = _mk_wk_rmp_pts(inp, bits)
                r_ch = _bld_rmp(wk, npoints)[ch]
                rl = 1 if eq else npoints
                d = (rmp_err[:, :rl]
                     + (blk[:, None, ch] - r_ch[None, :rl]) ** 2 * weights[ch])
                mse = (d.min(axis=1) * rpt).sum()
                if mse < best_e:
                    bst = inp[ch].copy()
                    best_e = mse
        inp[ch] = bst
        eq, wk = _mk_wk_rmp_pts(inp, bits)
        ramp = _bld_rmp(wk, npoints)
    return best_e, inp


def _refine_3d(inp0, blk, rpt, npoints, weights, steps, bits=(5, 6, 5)):
    """Refine3D (bcx:808-932): joint 6-D jitter sweep."""
    fctrs = np.array([1 << (8 - b) for b in bits], float)
    inp = inp0.copy()
    eq, wk = _mk_wk_rmp_pts(inp, bits)
    ramp = _bld_rmp(wk, npoints)
    best_e = _clstr_err(blk, rpt, ramp, npoints, eq, weights)
    best = inp0.copy()
    if best_e == 0.0 or not steps:
        return best_e, best
    lo, hi = -min(steps, 8), min(steps, 8)
    rng = range(lo, hi + 1)
    # order G, B, R to match the reference loop nest (bcx:854-929)
    for g0 in rng:
        inp[1, 0] = min(max(inp0[1, 0] + g0 * fctrs[1], 0.0), 255.0)
        for g1 in rng:
            inp[1, 1] = min(max(inp0[1, 1] + g1 * fctrs[1], 0.0), 255.0)
            for b0 in rng:
                inp[2, 0] = min(max(inp0[2, 0] + b0 * fctrs[2], 0.0), 255.0)
                for b1 in rng:
                    inp[2, 1] = min(max(inp0[2, 1] + b1 * fctrs[2], 0.0),
                                    255.0)
                    for r0 in rng:
                        inp[0, 0] = min(max(inp0[0, 0] + r0 * fctrs[0], 0.0),
                                        255.0)
                        for r1 in rng:
                            inp[0, 1] = min(max(inp0[0, 1] + r1 * fctrs[0],
                                                0.0), 255.0)
                            eq, wk = _mk_wk_rmp_pts(inp, bits)
                            ramp = _bld_rmp(wk, npoints)
                            mse = _clstr_err(blk, rpt, ramp, npoints, eq,
                                             weights)
                            if mse < best_e:
                                best_e = mse
                                best = inp.copy()
    return best_e, best


def _compress_rgb_block_x(blk_in, rpt, npoints, b3d, steps, weights,
                          bits=(5, 6, 5)):
    """CompressRGBBlockX (bcx:937-1203).  blk_in: (n,3) 0..255 unique."""
    n = len(blk_in)
    if n <= 2:
        rslt = np.stack([blk_in[0], blk_in[n - 1]], axis=1)
    else:
        blk01 = blk_in / 255.0
        line, mdl, sh = _find_axis(blk01, rpt)
        if line is None:
            rslt = np.stack([blk_in[0], blk_in[n - 1]], axis=1)
        else:
            err_g = 1e7
            line_g, pos_g = line.copy(), np.zeros(2)
            while True:
                prj0 = sh @ line
                prj_err = ((sh - line[None, :] * prj0[:, None]) ** 2
                           ).sum(axis=1)
                b0, b1 = prj0.min(), prj0.max()
                scl0 = b0 - (b1 - b0) * 0.125
                scl1 = b1 + (b1 - b0) * 0.125
                scl2 = (scl1 - scl0) ** 2
                prj = (prj0 - scl0) / (scl1 - scl0)
                pre = rpt * scl2
                pb0 = (b0 - scl0) / (scl1 - scl0)
                pb1 = (b1 - scl0) / (scl1 - scl0)
                stp = 0.025
                ls = pb0 - 2 * stp if pb0 - 2 * stp > 0 else 0.0
                he = pb1 + 2 * stp if pb1 + 2 * stp < 1 else 1.0
                err = _MAX_ERROR
                pos = np.zeros(2)
                for l in range(8):
                    lp = ls + l * stp
                    for h in range(8):
                        hp = he - h * stp
                        e = _ramp_srch_w(prj, prj_err, pre, err, lp, hp,
                                         npoints)
                        if e < err:
                            err = e
                            pos[:] = (lp, hp)
                pos = pos * (scl1 - scl0) + scl0
                if err + 0.001 < err_g:
                    err_g = err
                    line_g = line.copy()
                    pos_g = pos.copy()
                    step = (pos[1] - pos[0]) / (npoints - 1)
                    idx = np.where(
                        prj0 - pos[0] <= 0, 0.0,
                        np.where(prj0 - pos[1] >= 0, float(npoints - 1),
                                 np.floor((prj0 - pos[0] + step * 0.5)
                                          / step)))
                    idx = (idx - (npoints - 1) / 2.0) / (npoints - 1)
                    pm = idx * rpt
                    ln = (idx * pm).sum()
                    crs = (sh * pm[:, None]).sum(axis=0)
                    if ln > 0:
                        line = crs / ln
                        line = line / np.sqrt((line * line).sum())
                    else:
                        line = np.zeros(3)
                else:
                    break
            rslt = np.stack([(pos_g[k] * line_g + mdl) * 255.0
                             for k in range(2)], axis=1)
    on_grid = _mk_rmp_on_grid(rslt, bits)
    refine = _refine_3d if b3d else _refine
    _, out = refine(on_grid, blk_in, rpt, npoints, np.asarray(weights, float),
                    steps, bits)
    return out


def _clstr(blk255, endpoints_u8, npoints, weights, use_alpha, alpha01,
           alpha_threshold, bits=(5, 6, 5)):
    """Clstr (bcx:342-378): decoder-exact clusterize + DXTC index reorder."""
    c0 = _construct_colour(endpoints_u8[:, 0], bits)
    c1 = _construct_colour(endpoints_u8[:, 1], bits)
    e0, e1 = 0, 1
    if (npoints % 2 == 0 and c0 <= c1) or (npoints % 2 and c0 > c1):
        e0, e1 = 1, 0
    inp = np.stack([endpoints_u8[:, e0], endpoints_u8[:, e1]],
                   axis=1).astype(float)
    eq, wk = _mk_wk_rmp_pts(inp, bits)
    ramp = _bld_rmp(wk, npoints)
    rl = 1 if eq else npoints
    d = ((blk255[:, None, :] - ramp.T[None, :rl, :]) ** 2
         * np.asarray(weights, float)).sum(axis=2)
    raw = np.argmin(d, axis=1)
    err = d[np.arange(len(blk255)), raw].sum()
    # DXTC index reorder (bcx:308-312)
    idx = np.where(raw == npoints - 1, 1, np.where(raw > 0, raw + 1, 0))
    if use_alpha:
        transparent = alpha01 < alpha_threshold
        idx = np.where(transparent, npoints, idx)
    return err, idx


def _construct_colour(rgb_u8, bits=(5, 6, 5)):
    r, g, b = (int(rgb_u8[j]) >> (8 - bits[j]) for j in range(3))
    return (r << 11) | (g << 5) | b


def comp_rgba_block(block01: np.ndarray, npoints: int, b3d: bool, steps: int,
                    weights, use_alpha: bool, alpha_threshold01: float):
    """CompRGBABlock (bcx:1209-1297).  block01: (16,4) RGBA in [0,1].

    Returns (err, endpoints(3,2) uint8, indices(16)) or None if 4-pt ramp
    is invalid with transparency (bcx:1237-1238).
    """
    a = block01[:, 3]
    if use_alpha:
        sel = a >= alpha_threshold01
    else:
        sel = np.ones(16, bool)
    pts = block01[sel, :3]
    if len(pts) == 0:
        ep = np.array([[0, 255]] * 3, np.uint8)
        return 0.0, ep, np.full(16, 3 if npoints == 3 else 0, np.int64)
    if len(pts) != 16 and use_alpha and npoints % 2 == 0:
        return None
    uniq, rpt = _unique_colours(pts.astype(F))
    ep = _compress_rgb_block_x(uniq * 255.0, rpt, npoints, b3d, steps,
                               weights)
    ep_u8 = ep.astype(np.uint8)
    err, idx = _clstr(block01[:, :3] * 255.0, ep_u8.astype(float), npoints,
                      weights, use_alpha, a, alpha_threshold01)
    return err, ep_u8, idx


def encode_bc1_block(block01: np.ndarray, b3d=False, steps=1,
                     adaptive_weights=False, alpha_threshold01=0.0):
    """Image_CompressAMDBC1Block (amd_bcx_helpers.cpp:51-105)."""
    weights = calculate_colour_weightings(block01, adaptive_weights)
    use_alpha = alpha_threshold01 > 0.0
    r3 = comp_rgba_block(block01, 3, b3d, steps, weights, use_alpha,
                         alpha_threshold01)
    if r3 is not None and r3[0] == 0.0:
        r4 = None
    else:
        r4 = comp_rgba_block(block01, 4, b3d, steps, weights, use_alpha,
                             alpha_threshold01)
    if r4 is None or (r3 is not None and r3[0] <= r4[0]):
        err, ep, idx = r3
        npoints = 3
    else:
        err, ep, idx = r4
        npoints = 4
    c0 = _construct_colour(ep[:, 0])
    c1 = _construct_colour(ep[:, 1])
    if (npoints == 4 and c0 <= c1) or (npoints == 3 and c0 > c1):
        w0 = c1 | (c0 << 16)
    else:
        w0 = c0 | (c1 << 16)
    w1 = 0
    for i in range(16):
        w1 |= int(idx[i]) << (2 * i)
    return err, np.array([w0, w1], np.uint32)


def comp_block1(vals01: np.ndarray, npoints: int, fixed_ramp_points: bool):
    """CompBlock1 (bcx:1633-1832), int_prec=8 frac_prec=0 fixed ramp."""
    int_fctr = 256.0
    s = np.sort(vals01.astype(F), kind="stable")
    if fixed_ramp_points:
        mid = s[(s > 1.5 / 255.0) & (s < 253.5 / 255.0)]
    else:
        mid = s
    uniq, counts = np.unique(mid, return_counts=True)
    rpt = counts.astype(float)
    if len(uniq) <= 2:
        if len(uniq) == 2:
            r0 = np.floor(uniq[0] * (int_fctr - 1) + 0.5)
            r1 = np.floor(uniq[1] * (int_fctr - 1) + 0.5)
        elif len(uniq) == 1:
            r0 = np.floor(uniq[0] * (int_fctr - 1) + 0.5)
            r1 = r0 + 1.0
        else:
            r0, r1 = 128.0, 129.0
        ramp = [r0, r1]
    else:
        min_r, max_r = float(uniq[0]), float(uniq[-1])
        cntr = (min_r + max_r) / 2
        gbl_err = _MAX_ERROR
        gbl_l = gbl_r = 0.0
        if not (max_r - min_r <= 48.0 / int_fctr):
            llb = max(0.0, min_r - _GBL_SCH_EXT)
            rrb = min(1.0, max_r + _GBL_SCH_EXT)
            lrb = min(cntr, min_r + _GBL_SCH_EXT)
            rlb = max(cntr, max_r - _GBL_SCH_EXT)
            step_l = llb
            while step_l < lrb:
                step_r = rrb
                while rlb <= step_r:
                    e = _rmp_srch1(uniq, rpt, gbl_err, step_l, step_r,
                                   npoints)
                    if e < gbl_err:
                        gbl_err, gbl_l, gbl_r = e, step_l, step_r
                    step_r -= _GBL_SCH_STEP
                step_l += _GBL_SCH_STEP
            min_r, max_r = gbl_l, gbl_r
        m_step = _LCL_SCH_STEP / int_fctr
        _, min_r, max_r = _refine1(uniq, rpt, gbl_err, min_r, max_r, m_step,
                                   0.0, 1.0, npoints)
        ramp = [np.floor(min_r * (int_fctr - 1) + 0.5),
                np.floor(max_r * (int_fctr - 1) + 0.5)]
    if ramp[0] == ramp[1]:
        if ramp[1] < 255.0:
            ramp[1] += 1
        else:
            ramp[1] -= 1
    return ramp


def _rmp_srch1(vals, rpt, max_err, lo, hi, npoints):
    """RmpSrch1 (bcx:1510-1548)."""
    step = (hi - lo) / (npoints - 1)
    v = np.floor((vals - lo + step * 0.5) / step) * step + lo
    v = np.where(vals - lo <= 0, lo, np.where(vals - hi >= 0, hi, v))
    err = ((vals - v) ** 2 * rpt).sum()
    return max_err if err > max_err else err


def _refine1(vals, rpt, max_err, lo, hi, m_step, lbnd, hbnd, npoints):
    """Refine1 (bcx:1555-1607): 3x3 hill climb to convergence."""
    err = max_err
    while True:
        best = -1
        b_lo, b_hi = lo, hi
        for mode in range(9):
            c_lo = max(lo + m_step * _MV[mode // 3], lbnd)
            c_hi = min(hi + m_step * _MV[mode % 3], hbnd)
            e = _rmp_srch1(vals, rpt, err, c_lo, c_hi, npoints)
            if e < err:
                err, best, b_lo, b_hi = e, mode, c_lo, c_hi
        if best == -1:
            break
        lo, hi = b_lo, b_hi
    return err, lo, hi


def _clstr1(vals01, ramp, npoints, fixed_ramp_points):
    """Clstr1 + GetRmp1 (bcx:1409-1505)."""
    r0, r1 = float(ramp[0]), float(ramp[1])
    if r0 != r1:
        if (not fixed_ramp_points and r0 <= r1) or (fixed_ramp_points
                                                    and r0 > r1):
            r0, r1 = r1, r0
    pts = np.full(8, 1e5)
    pts[0], pts[1] = r0, r1
    for e in range(1, npoints - 1):
        pts[e + 1] = np.floor((r0 * (npoints - 1 - e) + r1 * e)
                              / (npoints - 1) + 0.5)
    total = npoints
    if fixed_ramp_points:
        pts[npoints] = 0.0
        pts[npoints + 1] = 255.0
        total = npoints + 2
    alpha = pts[:total] / 255.0
    d = (vals01[:, None] - alpha[None, :]) ** 2
    idx = np.argmin(d, axis=1)
    err = d[np.arange(len(vals01)), idx].sum()
    return err, idx, (r0, r1)


def comp_block1x(vals01: np.ndarray, npoints: int, fixed_ramp_points: bool):
    """CompBlock1X (bcx:1848-1868)."""
    ramp = comp_block1(vals01, npoints, fixed_ramp_points)
    err, idx, (r0, r1) = _clstr1(vals01.astype(F), ramp, npoints,
                                 fixed_ramp_points)
    return err, (int(r0), int(r1)), idx


def encode_alpha_block(vals01: np.ndarray) -> tuple[float, np.ndarray]:
    """Image_CompressAMDAlphaSingleModeBlock (amd_bcx_helpers.cpp:125-140):
    8-pt vs 6-pt race + DXT5 3-bit index packing (:32-46)."""
    e8, ep8, idx8 = comp_block1x(vals01, 8, False)
    if e8 == 0.0:
        e6, ep6, idx6 = np.inf, None, None
    else:
        e6, ep6, idx6 = comp_block1x(vals01, 6, True)
    if e8 <= e6:
        ep, idx, err = ep8, idx8, e8
    else:
        ep, idx, err = ep6, idx6, e6
    w0 = ep[0] | (ep[1] << 8)
    w1 = 0
    for i in range(16):
        v = int(idx[i]) & 7
        if i < 5:
            w0 |= v << (16 + i * 3)
        elif i > 5:
            w1 |= v << (2 + (i - 6) * 3)
        else:
            w0 |= (v & 1) << 31
            w1 |= (v & 6) >> 1
    return err, np.array([w0 & 0xFFFFFFFF, w1 & 0xFFFFFFFF], np.uint32)


def encode_explicit_alpha_block(vals01: np.ndarray) -> np.ndarray:
    """Image_CompressAMDExplictAlphaSingleModeBlock
    (amd_bcx_helpers.cpp:107-123)."""
    w = [0, 0]
    for i in range(16):
        c = int(vals01[i] * 255.0)
        c = (c + (7 if (c >> 4) < 8 else 8) - (c >> 4)) >> 4
        c = min(c, 0xF)
        w[i // 8] |= c << ((i % 8) * 4)
    return np.array(w, np.uint32)


def encode_rgb_block(block01_rgb: np.ndarray, b3d=False, steps=1,
                     adaptive_weights=False):
    """Image_CompressAMDRGBSingleModeBlock (amd_bcx_helpers.cpp:142-179):
    4-pt only."""
    rgba = np.concatenate([block01_rgb, np.ones((16, 1), F)], axis=1)
    weights = calculate_colour_weightings(rgba, adaptive_weights)
    err, ep, idx = comp_rgba_block(rgba, 4, b3d, steps, weights, False, 0.0)
    c0 = _construct_colour(ep[:, 0])
    c1 = _construct_colour(ep[:, 1])
    if c0 <= c1:
        w0 = c1 | (c0 << 16)
    else:
        w0 = c0 | (c1 << 16)
    w1 = 0
    for i in range(16):
        w1 |= int(idx[i]) << (2 * i)
    return err, np.array([w0, w1], np.uint32)


# ---- batch wrappers over (N,16,C) blocks --------------------------------

def encode_bc1_blocks(blocks01, use_alpha=False, alpha_threshold01=0.5,
                      b3d=False, steps=1, adaptive_weights=False):
    out = np.empty((len(blocks01), 2), np.uint32)
    thr = alpha_threshold01 if use_alpha else 0.0
    for i, b in enumerate(blocks01):
        _, out[i] = encode_bc1_block(np.asarray(b, F), b3d, steps,
                                     adaptive_weights, thr)
    return out


def encode_bc4_blocks(scalars01):
    out = np.empty((len(scalars01), 2), np.uint32)
    for i, v in enumerate(scalars01):
        _, out[i] = encode_alpha_block(np.asarray(v, F))
    return out


def encode_bc3_blocks(blocks01, b3d=False, steps=1, adaptive_weights=False):
    # the reference BC3 driver pairs the DXT5 alpha block with the 4-pt-only
    # RGB block (Image_CompressAMDRGBSingleModeBlock), NOT the BC1 3/4-pt
    # racer (amd_bc3_compressor.cpp:41-46)
    out = np.empty((len(blocks01), 4), np.uint32)
    for i, b in enumerate(blocks01):
        b = np.asarray(b, F)
        _, aw = encode_alpha_block(b[:, 3])
        _, cw = encode_rgb_block(b[:, :3], b3d, steps, adaptive_weights)
        out[i, :2] = aw
        out[i, 2:] = cw
    return out


def encode_bc2_blocks(blocks01, b3d=False, steps=1, adaptive_weights=False):
    # 4-bit explicit alpha + 4-pt-only RGB block (amd_bc2_compressor.cpp:41-46)
    out = np.empty((len(blocks01), 4), np.uint32)
    for i, b in enumerate(blocks01):
        b = np.asarray(b, F)
        out[i, :2] = encode_explicit_alpha_block(b[:, 3])
        _, cw = encode_rgb_block(b[:, :3], b3d, steps, adaptive_weights)
        out[i, 2:] = cw
    return out
