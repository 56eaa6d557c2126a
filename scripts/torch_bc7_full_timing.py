"""Times the full BC7 search (K5) of this checkout against the K5 of another
copy of the port's ``csrc/`` (``--parent``), on the same blocks, on one card,
in turns (``torch_turns.py``: the build side by side, the turns, the
comparison).

Both K5s are built from their own sources and called through their C
functions (``bc7_full_m02``, ``bc7_full_m1367``, ``bc7_full_m45``: the same
signature in both). The shortlists come from this checkout's K3 and are the
same for both. Each measurement is taken as old, new, new, old (the two
readings of each side are reported), per budget tier of ``compress(DXBC7)``:
the search budgets that ``bc7_full._plan`` gives for quality 1.0, 0.5 and
0.25 and for performance 0.3 (``TIERS``):

- ``path_1k``: the eight mode launches of one ``compress(DXBC7)`` chunk of the
  1024x1024 photo of ``chip_smoke.py`` (65,536 blocks), each iteration right
  after the chunk's shortlist launches, as the main path runs them (the
  shortlists not timed);
- ``mode_1k``: each mode alone, back to back (what a ``mode_mask`` of one
  mode runs);
- at quality 1.0 only, ``alone_1k``: the eight launches back to back on
  shortlists computed once; ``path_13x257``: the eight launches on the
  260 blocks of the 13x257 photo, after their shortlists; and
  ``compress_1k``: the whole ``compress(DXBC7)`` call on the 1024x1024 photo,
  as ``chip_smoke.py`` times it (``time_ms``), with the port's launches routed
  through each side's K3 and K5 in turn.

Both K5s' words and errors are compared on the 1K blocks at every tier, and
the two ``compress()`` outputs (they must be equal: each equals its plain
version bit for bit). Needs a CUDA device. From the root of the repo:

    python3 scripts/torch_bc7_full_timing.py --parent DIR [--out results.json]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from torch_turns import (arguments, blocks_differing, call, device, finish,
                         function, in_turns, port_libraries, start_build)
from chip_smoke import launch_ms, photo_rgba, time_ms
import gfx_imagecompress_tpu_torch as gic
from gfx_imagecompress_tpu_torch.kernels import _build, bc7_est, bc7_full
from gfx_imagecompress_tpu_torch.pipeline.blocks import image_to_blocks

LIBS = ("bc7_full_m02", "bc7_full_m1367", "bc7_full_m45")
# K3 and K5: what compress(DXBC7) launches
SOURCES = {lib: _build.SOURCES[lib][0] for lib in ("bc7_est", *LIBS)}


def launch(fns, x, mode, plan, bar, ids, merge, words, err):
    """One mode's search through the C functions ``fns``, on the current
    stream."""
    ids_p, nids = None, 0
    if isinstance(ids, int):
        nids = ids
    elif ids is not None:
        ids_p, nids = ids, ids.shape[1]
    call(fns[bc7_full.MODE_FUNCTIONS[mode]], x, x.shape[0], mode, ids_p, nids,
         plan.iters, plan.shake, plan.uber, plan.keep,
         bar if mode >= 6 else None, int(merge), words, err)


def outputs(x):
    n = x.shape[0]
    return (torch.empty((n, 4), dtype=torch.int32, device=x.device),
            torch.empty((n,), dtype=torch.float32, device=x.device))


def searches(fns, x, plan, bar, ids_of):
    """The eight mode searches of one chunk, merged into one running
    (words, err) pair."""
    words, err = outputs(x)
    for i, mode in enumerate(plan.modes):
        launch(fns, x, mode, plan, bar, ids_of(mode), i > 0, words, err)
    return words, err


def one_mode(fns, x, plan, bar, ids_of, mode):
    launch(fns, x, mode, plan, bar, ids_of(mode), False, *outputs(x))


# tier name -> (quality, performance) of compress(DXBC7), as chip_smoke.py
# names them
TIERS = {"q1": (1.0, 1.0), "q05": (0.5, 1.0), "q025": (0.25, 1.0),
         "q1_performance03": (1.0, 0.3)}


def main() -> int:
    args = arguments(__doc__).parse_args()
    smi = device()
    if smi is None:
        print("needs a CUDA device", file=sys.stderr)
        return 1
    _build.ensure_built()
    waits = {"old": start_build(args.parent, "k5_old", SOURCES),
             "new": start_build(_build.CSRC, "k5_new", SOURCES)}
    libs, side, resources = {}, {}, {}
    for s, wait in waits.items():
        libs[s], resources[s] = wait()
        side[s] = {lib: function(libs[s], lib) for lib in LIBS}
    names = list(side)
    res = {"device": smi, "reps": args.reps, "order": "old new new old",
           "resources": resources, "tiers": {}}

    def setup(img, plan):
        cfgs = plan.shortlists
        x = image_to_blocks(torch.from_numpy(img[None]).cuda())
        x = x[..., :4].contiguous()
        bar = bc7_full._combined_alpha_bar(x, True, True)
        pre = {}
        keys = {tuple(sorted(c.items())): c for c in cfgs.values()
                if isinstance(c, dict)}

        def shortlists():
            for key, c in keys.items():
                pre[key] = bc7_est.estimate_topk(x, **c)

        def ids_of(m):
            c = cfgs.get(m)
            return pre[tuple(sorted(c.items()))] if isinstance(c, dict) else c

        shortlists()
        return x, bar, shortlists, ids_of

    photo = photo_rgba(1024, 1024, seed=110)
    ok = True
    for tier, (quality, performance) in TIERS.items():
        plan = bc7_full._plan(quality, 0xFF, performance, None, None, None,
                              None)
        x, bar, shortlists, ids_of = setup(photo, plan)
        wo, eo = searches(side["old"], x, plan, bar, ids_of)
        wn, en = searches(side["new"], x, plan, bar, ids_of)
        torch.cuda.synchronize()
        t = {"budget": [plan.iters, plan.shake, plan.uber, plan.keep],
             "n_blocks_1k": int(x.shape[0]),
             "words_equal_frac": (wo == wn).all(1).double().mean().item(),
             "errors_equal": bool(torch.equal(eo, en))}
        ok = ok and t["words_equal_frac"] == 1.0 and t["errors_equal"]
        t["path_1k"] = in_turns(names, lambda s: launch_ms(
            shortlists, lambda: searches(side[s], x, plan, bar, ids_of),
            args.reps))
        t["mode_1k"] = {m: in_turns(names, lambda s, m=m: time_ms(
            lambda: one_mode(side[s], x, plan, bar, ids_of, m), args.reps))
            for m in plan.modes}
        if tier == "q1":
            t["alone_1k"] = in_turns(names, lambda s: time_ms(
                lambda: searches(side[s], x, plan, bar, ids_of), args.reps))
            xs, bars, shorts, ids_s = setup(photo_rgba(13, 257, seed=113),
                                            plan)
            t["n_blocks_13x257"] = int(xs.shape[0])
            t["path_13x257"] = in_turns(names, lambda s: launch_ms(
                shorts, lambda: searches(side[s], xs, plan, bars, ids_s),
                args.reps))
            img = gic.Image.from_array(np.ascontiguousarray(photo[None]))
            outs = {}
            for s in names:
                with port_libraries(libs[s]):
                    outs[s] = (gic.compress(gic.CompressType.DXBC7, img)
                               .blocks.reshape(-1, 4),)
            torch.cuda.synchronize()
            t["compress_1k_blocks_differing"] = blocks_differing(
                outs["old"], outs["new"])
            ok = ok and t["compress_1k_blocks_differing"] == 0

            def compress_ms(s):
                with port_libraries(libs[s]):
                    return time_ms(lambda: gic.compress(
                        gic.CompressType.DXBC7, img), args.reps)
            t["compress_1k"] = in_turns(names, compress_ms)
        res["tiers"][tier] = t
    return finish(res, args.out, ok)


if __name__ == "__main__":
    sys.exit(main())
