"""Roofline counts of the port's block encoders on one NVIDIA H100.

The operations and bytes each kernel needs for one 4x4 block, counted from
its search loops, and the card's published peaks they are held against.
``chip_smoke.py`` bounds each kernel's time with them and ``bench.py``
reports each bench config's share of them (``_ops_util``, ``_hbm_frac``).
They take the place of the JAX package's ``flops_model.json``, whose XLA
cost-analysis flops and TPU peaks mean nothing on the card.
"""
from __future__ import annotations

import torch

from .kernels import bc4
from .tables.bc6h_tables import BC6H_MODES

# Published peaks of one H100 SXM (NVIDIA data sheet), used for the bounds:
# 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


# ---- operation counts per 4x4 block, counted from the search loops.
# One f32/i32 add, sub, mul, div, min/max, compare or select = 1 operation
# (the kernels are built without multiply-add contraction). The count is what
# the search needs, not what a kernel happens to execute: a value that does
# not depend on the pixel (a candidate's ramp levels, a palette) is counted
# once per candidate, not once per pixel; the principal axis and the
# projections are counted once per block although both colour modes use them;
# an error that the seed race already produced is not counted again at the
# start of a climb; and a hill-climb candidate is counted only where this
# run's data gives it a valid endpoint order (``bc4_climb_evals``).

def bc4_climb_evals(vals01, iters=3, radius=2, rounds=2):
    """Hill-climb candidates per block that the scalar search has to evaluate
    on this data, as means over the blocks: (8-point family, 6-point family).
    A candidate whose endpoint order is wrong for its family can never win and
    needs no evaluation; that happens only where the two endpoints lie within
    the climb radius of each other. Nor does a candidate of a later round that
    lies inside the previous round's (clamped) box: the previous round already
    bettered or matched it, and only a strictly smaller error wins. vals01 is
    (N,16) in [0,1]."""
    vals = vals01.t() * 255.0
    means = []
    for eight, seed in ((True, bc4._seed8), (False, bc4._seed6)):
        s0, s1 = seed(vals, iters)
        total = 0
        box = None
        for r in range(rounds):
            rad = radius if r == 0 else 1
            c0, c1 = (s0, s1) if r == 0 else bc4._sweep(
                vals, s0, s1, radius, eight, r)[:2]
            for d0 in range(-rad, rad + 1):
                for d1 in range(-rad, rad + 1):
                    if d0 == 0 and d1 == 0:
                        continue
                    a = torch.clamp(c0 + d0, 0, 255)
                    b = torch.clamp(c1 + d1, 0, 255)
                    need = (a > b) if eight else (a <= b)
                    if box is not None:
                        lo0, hi0, lo1, hi1 = box
                        need &= ~((a >= lo0) & (a <= hi0)
                                  & (b >= lo1) & (b <= hi1))
                    total += need.sum().item()
            box = (torch.clamp(c0 - rad, 0, 255), torch.clamp(c0 + rad, 0, 255),
                   torch.clamp(c1 - rad, 0, 255), torch.clamp(c1 + rad, 0, 255))
        means.append(total / vals.shape[1])
    return tuple(means)


def ops_bc4(climb8, climb6, iters=3):
    """Operations of the scalar search for one channel of one block."""
    # one exact-ramp error: the integer ramp (6 or 4 interpolated entries x
    # (2 mul, 2 add, div)), then per pixel 8 entries x (sub, mul) and 7 min,
    # and 15 adds for the sum
    ev8 = 30 + 16 * (8 * 2 + 7) + 15
    ev6 = 20 + 16 * (8 * 2 + 7) + 15
    # one least-squares round: per level the interpolated value (mul, add) and
    # per pixel (sub, mul, compare, 2 selects); 11 ops of normal-equation
    # terms per pixel (6-point: 15, plus 9 for the literal 0/255 slots);
    # e1-e0 and the 2x2 solve, 17
    fit8 = iters * (16 * (8 * 5 + 11) + 3 * 8 + 17)
    fit6 = iters * (16 * (6 * 5 + 9 + 15) + 3 * 6 + 17)
    seeds = 30 + 2 * ev8 + 63 * 2 + 10 * ev6     # min/max, race, sort, race
    climb = climb8 * (ev8 + 5) + climb6 * (ev6 + 5)
    final = 30 + 16 * (8 * 2 + 7 * 3) + 40       # indices of the winner, pack
    return fit8 + fit6 + seeds + climb + final


def ops_bc1(iters=3, passes=1, allow_three=True):
    """Operations of the colour search for one opaque block with fixed
    weights (the main path's settings)."""
    pca = 48 + 16 * 15 + 8 * 30 + 15     # mean, covariance, power iteration
    proj = 16 * 10                       # projection on the axis, extents
    n = pca + proj + 40                  # + endpoint order, final select
    for k in ((4, 3) if allow_three else (4,)):
        pal = 3 * (6 + (8 if k == 4 else 3))     # exact palette, 3 channels
        # 24 endpoint positions: k ramp levels once per candidate, then per
        # pixel k x (sub, mul, min) and the add
        sweep = 24 * (16 * (k * 3 + 1) + 3 * k)
        # two starts x iters least-squares rounds, then quantise
        lsq = 2 * (iters * (16 * (28 + 4 * (k - 1)) + 45) + 24)
        # per pixel and palette entry: weighted distance 11, unweighted 5,
        # compare and 3 selects
        ev_err = pal + 16 * (k * 11 + k)
        ev_full = pal + 16 * (k * 16 + (k - 1) * 4 + 4)
        # jitter: per channel the distance over the two channels that stay
        # (10 per pixel and entry), then 8 moves
        per_ch = 16 * k * 10 + 8 * (
            14 + 16 * (k * 6 + (k - 1) * 3 + 2) + 6)
        n += sweep + lsq + 2 * ev_err + 2 * ev_full + passes * 3 * per_ch
    return n + (16 * 6 if allow_three else 0)


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


def ops_bc6h(topk=4, iters=2, shake=1, mode_mask=0xFFFF, fallback=False):
    """Operations of the BC6H search for one block, counted like
    ``ops_bc7_full``: the work-domain floats once per block, per-pixel work
    over the pixels a pass visits (each pixel against its own region's
    palette, and in its own region's fit), pixel-independent values (a
    palette's decoded entries, a fit's levels) once per candidate."""
    two = [mi for mi in range(10) if (mode_mask >> mi) & 1]
    one = [mi for mi in range(10, 14) if (mode_mask >> mi) & 1]

    def fit(levels, regions):
        # per pixel, once over the 16 (each pixel in its own region's fit):
        # the mask and count (2), the means' terms (6), centring and
        # covariance (18), projection and extremes (9), and per
        # least-squares round the nearest level (11 per level) and the
        # normal-equation terms (25); per region: the means' divisions (3),
        # 8 power rounds of 30, normalise 15, ends 12, and per least-squares
        # round the levels (9 each) and the solve (31)
        px = 16 * (2 + 6 + 18 + 9) + iters * 16 * (11 * levels + 25)
        reg = 3 + 8 * 30 + 15 + 12 + iters * (9 * levels + 31)
        return px + regions * reg

    def palette(entries, regions):
        # decoded entries: per entry and channel the integer lerp (5), the
        # finish (3) and the conversion (1); per pixel: per entry 3 sub, 3
        # mul, 2 add, the compare and 2 selects, then the sum and the index
        return regions * entries * 27 + 16 * (11 * entries + 8)

    def shake_round(entries, regions):
        # per channel 9 evaluations (the start and 8 steps): 2 unquantised
        # codes (12) per region, 13 per pixel (lerp, finish, conversion,
        # difference, square, sum); clamps and the race, 7 per step; the
        # weights 3 per pixel; the requantise palette
        return (3 * (9 * 12 * regions + 9 * 13 * 16 + 8 * 7) + 16 * 3
                + 12 * regions + palette(entries, regions))

    n = 48 + 300                      # work-domain floats; the pack
    if two:
        # the estimate of 32 shapes: per pixel the mean (3), the box (9),
        # the projection and its extremes (10), the quantised projection and
        # the error (26); per region 19; the top-k, 64 per kept shape
        n += 32 * (16 * 48 + 2 * 19) + 64 * topk
        groups = len({BC6H_MODES[mi].base_bits for mi in two})
        # per kept shape: the two regions' fits; per precision group the
        # quantised and unquantised endpoints (168), both regions' palettes,
        # the swaps (100); per mode the gate and the merge (50)
        n += topk * (fit(8, 2) + groups * (168 + palette(8, 2) + 100)
                     + 50 * len(two))
        if shake:
            n += shake * shake_round(8, 2) + 100
    if one:
        n += fit(16, 1) + len(one) * (84 + palette(16, 1) + 60)
        if shake:
            n += shake * shake_round(16, 1) + 60
    if fallback:
        n += 48 + 24 + palette(16, 1)
    return n


def ops_per_block(name, x, **fast_budget):
    """Operations per block of kernel ``name`` (``bc1``-``bc5``,
    ``bc7_fast``) on the input ``x``; ``fast_budget`` goes to
    ``ops_bc7_fast``."""
    scalar = {"bc3": [3], "bc4": [None], "bc5": [0, 1]}.get(name, [])
    n = sum(ops_bc4(*bc4_climb_evals(
        x if ch is None else x[:, :, ch].contiguous())) for ch in scalar)
    if name == "bc1":
        n += ops_bc1()
    elif name in ("bc2", "bc3"):
        n += ops_bc1(allow_three=False)
    if name == "bc2":
        n += 16 * 10                 # explicit 4-bit alpha and its error
    if name == "bc7_fast":
        opaque = ((x[..., 3] * 255.0).amin(1) >= 254.999).double().mean()
        n += ops_bc7_fast(opaque_frac=opaque.item(), **fast_budget)
    return n


def bytes_bc7_full(unbarred_frac=0.0, k=8):
    """Bytes per block of the full BC7 search's eight launches: the block
    read by each mode that runs on it (modes 6/7 skip barred blocks after
    reading their bar byte), the shortlists of modes 1, 3, 2 and 7 (``k`` ids
    each), each mode's words and error written and the running error read by
    modes 1-7."""
    return int(round(6 * 256 + 2 + unbarred_frac * 2 * 256
                     + 4 * k * (3 + unbarred_frac) + 8 * 20 + 7 * 4))


def bound(n_blocks, bytes_per_block, ops_per_block):
    t_bytes = n_blocks * bytes_per_block / PEAK_BYTES_PER_S * 1e3
    t_ops = n_blocks * ops_per_block / PEAK_F32_OPS_PER_S * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"))
