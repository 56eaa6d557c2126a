"""Frozen copy of the port's roofline counts (``roofline.py``) for the
kernels the benchmark's cells run: the partition shortlist (K3), the fast BC7
search (K4) and the full BC7 search (K5), per 4x4 block, and the card's
published peaks. A later change to the program cannot move them; a test
holds them equal to the program's counts as they stood when they were
copied. ``launch_bound`` turns them into the least time of one launch.
"""
from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA data sheet), used for the bounds:
# 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def ops_bc7_est(chans=3, subsets=2, nparts=64, k=4, pca=False):
    """Operations of the partition shortlist for one block. Every partition
    covers the 16 pixels once, whatever its subsets' sizes."""
    nc = chans
    # per pixel: mean add and centring (2 nc), projection (2 nc - 1), its
    # extremes (2), quantise and reconstruct (7), distance to the axis
    # (2 nc + 1), quantisation error and the running sum (4)
    pixel = 6 * nc + 13
    if pca:
        # covariance terms per pixel; per subset 4 power rounds of a
        # matrix-vector product, its length and the scaled vector
        pixel += nc * (nc + 1)
        subset = 4 * (2 * nc * nc + 3 * nc + 3)
    else:
        pixel += 2 * nc                  # bounding box, min and max
        subset = 4 * nc + 2              # its diagonal, normalised
    subset += nc + 2                     # the mean's division, the span
    # k running best: one compare per partition and the shift of k slots
    return nparts * (16 * pixel + subsets * subset + 1 + k)


def ops_bc7_fast(perceptual=True, uber=4, k=4, opaque_frac=1.0):
    """Operations of the fast BC7 search for one block: mode 6 always, mode 1
    for the opaque share of this run's blocks. Counted the GPU way: the
    palette entry a pixel selects is computed from its index (no select
    chain), metric-space pixels once per block, pixel-independent values once
    per candidate, a masked pass only over its subset's pixels (a partition's
    two subsets cover the 16 pixels once)."""
    met = 15 if perceptual else 0        # 3x3 map: 9 mul, 6 add

    def assign(nc, levels):
        # per pixel: projection (3 nc), level index (compare + add per
        # midpoint), weight of the index (3), integer lerp (5 nc + 1) and
        # conversion (nc), its metric map, weighted squared distance (4 nc),
        # running sum
        pixel = 3 * nc + 2 * (levels - 1) + 3 + 6 * nc + 1 + met + 4 * nc + 1
        # per candidate: both ends' metric map, direction, length, inverse
        return pixel, 2 * met + 4 * nc + 4

    def lsq(nc):
        # per pixel: level of the index (5), 1 - a, three products and sums,
        # two per channel; per call: determinant, test, inverse, two solved
        # ends per channel
        return 12 + 4 * nc, 7 + 10 * nc

    def variants(uber):
        if uber <= 0:
            return 0, 0
        q = uber - 2 if uber >= 4 else 1
        return 3, ((q + 2) ** 2 - 1 if uber >= 2 else 0)

    n_pert, n_scale = variants(uber)
    perturb, scale = 16 * 6, 16 * 9      # variant indices for 16 pixels
    pbit = 16                            # one endpoint channel under one p

    # ---- mode 6
    a_px, a_c = assign(4, 16)
    l_px, l_c = lsq(4)
    # mean, centring, covariance, 8 power rounds, normalise, projections and
    # extremes, ends; 2 rounds of projection indices + least squares
    fit4 = (68 + 64 + 320 + 8 * 47 + 19 + 112 + 32 + 16
            + 2 * (15 + 16 * (12 + 30) + 16 * l_px + l_c))
    race6 = 2 * (2 * 4 * pbit + 11) + a_c + 16 * a_px + 12
    refit6 = 16 * l_px + l_c
    n6 = 2 + n_pert + n_scale
    mode6 = (fit4 + n6 * race6 + (n6 - 1) * refit6
             + (32 if uber > 0 else 0) + n_pert * perturb + n_scale * scale)

    # ---- mode 1, per partition (both subsets together = 16 pixels)
    a_px, a_c = assign(3, 8)
    l_px, l_c = lsq(3)
    fit3 = (54 + 48 + 192 + 2 * 8 * 30 + 30 + 80 + 32 + 8 + 24
            + 2 * (2 * 13 + 16 * (9 + 14) + 16 * l_px + 2 * l_c))
    quant1 = 2 * (2 * 2 * 3 * pbit + 14) + 2 * a_c + 16 * a_px + 10
    solid = 30 + a_c + 16 * a_px + 16
    uber1 = (n_pert * perturb + n_scale * scale
             + (n_pert + n_scale) * (16 * l_px + 2 * l_c + quant1)
             + (64 if uber > 0 else 0))
    mode1 = k * (fit3 + quant1) + solid + uber1

    # metric pixels once, the alpha test, packing
    return (16 * met + 16 + 150) + mode6 + opaque_frac * mode1


FULL_MODES = {  # mode: subsets, channels searched, p-bit combos, index bits,
    #              alpha-index bits of a dual mode, index selections
    0: (3, 3, 4, 3, 0, 1), 1: (2, 3, 2, 3, 0, 1), 2: (3, 3, 1, 2, 0, 1),
    3: (2, 3, 4, 2, 0, 1), 4: (1, 3, 1, 2, 3, 2), 5: (1, 3, 1, 2, 2, 1),
    6: (1, 4, 4, 4, 0, 1), 7: (2, 4, 4, 2, 0, 1)}


def ops_bc7_full_mode(mode, iters=3, shake=3, uber=4, topk=8, keep=2,
                      parts0=16):
    """Operations of one mode of the full BC7 search for one block, counted
    like ``ops_bc7_fast``: per-pixel work over the pixels a pass visits (a
    partition's subsets cover the 16 pixels once), pixel-independent values
    once per call, the palette entry a pixel selects (no select chain)."""
    s, nc, combos, ib, aib, nsel = FULL_MODES[mode]
    lv = 1 << ib

    def assign(nc, lv):
        # per pixel: projection (3 nc), level index (2 per midpoint), weight
        # (3), integer lerp and conversion (6 nc), distance and sum (3 nc + 1)
        return 12 * nc + 2 * (lv - 1) + 4, 4 * nc + 4

    def fit(nc, lv, subsets):
        # per pixel: mean, centring, covariance terms, projection + extremes;
        # per subset: the mean's division, 8 power rounds, normalise, ends;
        # per round per pixel: projection index and level, least-squares terms
        px = nc * nc + 6 * nc + 2
        sub = 16 * nc * nc + 31 * nc + 40
        rnd = 16 * (7 * nc + 2 * lv + 13) + subsets * (14 * nc + 11)
        return 16 * px + subsets * sub + iters * rnd

    def quant(nc, lv, subsets, race):
        # p-bit race by rounding error (two quantisations, two squares per
        # channel and combination), then `race` exact assigns
        a_px, a_c = assign(nc, lv)
        race_ops = subsets * (4 * nc + combos * (nc * 24 + 4)) if combos > 1 \
            else subsets * nc * 14
        return race_ops + race * (16 * a_px + subsets * (a_c + nc * 18 + 2))

    def variants(u):
        if u <= 0:
            return 0, 0
        q = u - 2 if u >= 4 else 1
        return 3, ((q + 2) ** 2 - 1 if u >= 2 else 0)

    def uber_ops(nc, lv, subsets, u, race):
        npert, nscale = variants(u)
        lsq = 16 * (12 + 4 * nc) + subsets * (7 + 10 * nc)
        return (16 * (npert * 6 + nscale * 9 + 2)
                + (npert + nscale) * (lsq + quant(nc, lv, subsets, race)
                                      + subsets * 2))

    def shake_ops(nc, lv, subsets, rounds, srange, combos_):
        steps = (2 * srange + 1) ** 2
        a_px, a_c = assign(nc, lv)
        per_round = (nc * steps * (16 * 12 + subsets * 17)
                     + combos_ * (16 * a_px + subsets * (a_c + 10 * nc + 2)))
        return rounds * per_round

    if mode in (4, 5):
        la = 1 << aib
        scalar_fit = (iters * (16 * (la * 6 + 10) + 14) + 30 + 14
                      + 16 * la * 8)
        cand = (fit(3, lv, 1) + quant(3, lv, 1, 1) + scalar_fit + 2)
        n = 4 * nsel * cand
        refines = keep if (uber or shake) else 0
        u2 = min(uber, 2)
        npert, nscale = variants(u2)
        per = 0
        if u2:
            per += uber_ops(3, lv, 1, u2, 1)
            per += (npert + nscale) * (16 * 16 + 14 + 16 * la * 8 + 2)
        if shake:
            per += shake_ops(3, lv, 1, shake, 1, 1)
            per += shake * (9 * (16 * 12 + 17) + 16 * (2 * la + 14) + 10)
        return n + refines * (per + 8 * 64) + 200
    race = 2 if mode == 0 else 1
    u = uber + 2 if (mode == 0 and uber) else uber
    k = 1 if s == 1 else (parts0 if mode == 0 else topk)
    keep2 = s >= 2 and mode in (0, 2, 7) and k > 1 and (uber or shake)
    n = k * (fit(nc, lv, s) + quant(nc, lv, s, race) + 4 * s)
    if uber or shake:
        per = (uber_ops(nc, lv, s, u, race) if u else 0) + (
            shake_ops(nc, lv, s, shake, 2 if shake >= 3 else 1, combos)
            if shake else 0)
        n += (2 if keep2 else 1) * per
    return n + 150 + (48 if mode < 4 else 0)


def ops_bc7_full(unbarred_frac=0.0, **budget):
    """Operations of the full BC7 search for one block over modes 0-7 at a
    budget; modes 6/7 only for the share of blocks they are not barred from
    (a barred block's thread returns at once)."""
    n = 64                                 # the block scaled to 0..255, once
    for m in range(8):
        ops = ops_bc7_full_mode(m, **budget)
        n += ops * (unbarred_frac if m >= 6 else 1.0)
    return n


def bytes_bc7_full(unbarred_frac=0.0, k=8):
    """Bytes per block of the full BC7 search's eight launches: the block
    read by each mode that runs on it (modes 6/7 skip barred blocks after
    reading their bar byte), the shortlists of modes 1, 3, 2 and 7 (``k`` ids
    each), each mode's words and error written and the running error read by
    modes 1-7."""
    return int(round(6 * 256 + 2 + unbarred_frac * 2 * 256
                     + 4 * k * (3 + unbarred_frac) + 8 * 20 + 7 * 4))


def launch_bound(ops: float, nbytes: float) -> float:
    """Least seconds the card needs for ``ops`` float32 operations and
    ``nbytes`` bytes of device memory: the larger of the two bounds."""
    return max(ops / PEAK_F32_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)
