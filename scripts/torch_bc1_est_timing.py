"""Times the BC1 kernel (K1a), the BC3 and BC2 kernels (K1b, K1c, whose
colour half shares K1a's helpers: K1b runs K1a's lane groups beside the
scalar search's two families, K1c the one-thread colour search), the BC4 and
BC5 kernels (K2a, K2b, the scalar search on a group of lanes per block and
channel, sharing the ramp helpers of K1b's alpha half) and the BC7 partition
shortlist (K3) of this checkout against those of another copy of the port's
``csrc/`` (``--parent``), on the same blocks, on one card, in turns
(``torch_turns.py``: the build side by side, the turns, the comparison).

Both sides are built from their own sources (``bc1_kernel.cu``,
``bc23_kernels.cu``, ``bc45_kernels.cu`` and ``bc7_est_kernel.cu``) and
called through their C functions: ``bc1_encode``, ``bc3_encode``,
``bc2_encode``, ``bc4_encode`` and ``bc5_encode`` have one signature in
both; this checkout's ``bc7_est_topk`` also takes the order in which the
partitions are dealt to its lanes and a per-block bar; the parent's is taken
to be the one-thread design's, which takes neither. Each measurement
is taken in turns, every side in order and then in reverse (old, new, new,
old; both readings of each side are reported), CUDA events around launches
queued behind a device-side sleep (``chip_smoke.queued_ms``), so that the
host's launch cost does not show, after a warm-up call (and, before the
first, about two seconds of K1a on both sides). ``--parts`` picks what is
timed (default all):

- ``k1a``: K1a at ``chip_smoke.py``'s six BC1 budgets (default, use_alpha,
  four_only, adaptive, b3d, b3d_use_alpha), on the 4096x4096 photo of
  ``chip_smoke.py`` (1,048,576 blocks; with an alpha field for the
  punch-through budgets) and on the 13x257 photo (260 blocks); and, to see
  where its time goes, the default budget without the refine
  (``no_refine``) and without the refine and the least-squares rounds
  (``no_refine_no_lsq``), at 4096x4096;
- ``bc23``: K1b at its default and ``alpha_r1`` (a_radius 1, a_rounds 1)
  budgets, K1c at its default and ``adaptive`` budgets, on
  ``chip_smoke.py``'s BC3 and BC2 images (1024x1024 photos with an alpha
  field, 65,536 blocks) and at the default budgets on the 13x257 photo with
  an alpha field; on the 1024x1024 images also as ``compress()`` runs them:
  the kernel right after ``image_to_blocks`` (``chip_smoke.launch_ms``) and
  the whole ``compress(DXBC3)`` / ``compress(DXBC2)`` call as
  ``chip_smoke.py`` times it (``time_ms``), with the port's launches routed
  through each side's library (``torch_turns.port_libraries``);
- ``bc45``: K2a and K2b on ``chip_smoke.py``'s 512x512 BC4 and BC5 images
  (16,384 blocks) at the default, ``r1`` (radius 1, rounds 1) and ``r3``
  (radius 3, rounds 3) budgets, and at the default on the 13x257 photo (260
  blocks), BC4 at 4096x4096 (1,048,576 blocks) and BC5 at 2048x2048
  (262,144); at 512x512 also as ``compress()`` runs them: the kernel right
  after ``image_to_blocks`` and the whole ``compress(DXBC4)`` /
  ``compress(DXBC5)`` call, routed through each side's library.
  ``--lanes 1,2,4x256`` adds builds of this checkout's K2a and K2b at other
  launch shapes (``scripts/torch_lanes_bc45.cu``: the same templates and C
  functions at ``-DSWEEP_LANES=n``, and ``-DSWEEP_THREADS=t`` where the entry
  is ``nxt``), timed beside the two sides in this part;
- ``k3``: K3 at its four configurations on the main paths (the fast path's
  (3 channels, 2 subsets, 64 partitions, 8 levels, k 4) and the full path's
  three: (3, 2, 64, 8, k 8), (3, 3, 64, 4, k 8), (4, 2, 64, 4, k 8, PCA)), on
  the 1024x1024 photo (65,536 blocks), the same photo with an alpha field,
  and the 13x257 photo; the new side without the bar and with the full BC7
  entry's mode 6/7 bar of that image (the old side has no bar).

Words, errors and ids of every side are compared with the old side's
wherever both rank every block (they must be equal: each equals its plain
version bit for bit); with the bar, the new side's ids are compared with
the old side's on the blocks that are not barred. The registers and spills
of every build are reported from ``ptxas -v``. Needs a CUDA device. From
the root of the repo:

    python3 scripts/torch_bc1_est_timing.py --parent DIR \
        [--parts k1a,bc23,bc45,k3] [--lanes 1,2,4,8] [--out results.json]
"""
from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from torch_turns import (ROOT, arguments, blocks_differing, call, device,
                         finish, function, in_turns, port_libraries,
                         start_build)
from chip_smoke import (launch_ms, photo_rgba, queued_ms, time_ms,
                        with_alpha_field)
import gfx_imagecompress_tpu_torch as gic
from gfx_imagecompress_tpu_torch.kernels import _build, bc1, bc7_est, bc7_full
from gfx_imagecompress_tpu_torch.pipeline.blocks import image_to_blocks

P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# bc7_est_topk of the one-thread K3, the parent's design: no deal order, no bar
EST_ARGS_PARENT = (P, LL, I, I, P, I, I, I, I, P)
SOURCES = {"bc1": "bc1_kernel.cu", "bc23": "bc23_kernels.cu",
           "bc45": "bc45_kernels.cu", "bc7_est": "bc7_est_kernel.cu"}
PARTS = ("k1a", "bc23", "bc45", "k3")
LANE_SOURCES = {"bc45": ROOT / "scripts" / "torch_lanes_bc45.cu"}
BC45_BUDGETS = {"default": {}, "r1": {"radius": 1, "rounds": 1},
                "r3": {"radius": 3, "rounds": 3}}
BC3_BUDGETS = {"default": {}, "alpha_r1": {"a_radius": 1, "a_rounds": 1}}
BC2_BUDGETS = {"default": {}, "adaptive": {"adaptive": True}}

THR = 128 / 255.0
BC1_BUDGETS = {
    "default": {},
    "use_alpha": {"use_alpha": True, "alpha_threshold": THR},
    "four_only": {"allow_three": False},
    "adaptive": {"adaptive": True},
    "b3d": {"b3d": True},
    "b3d_use_alpha": {"b3d": True, "use_alpha": True, "alpha_threshold": THR},
}
# the default budget with parts of the search left out (4096x4096 only)
BC1_PARTS = {"no_refine": {"passes": 0},
             "no_refine_no_lsq": {"passes": 0, "iters": 0}}
EST_CONFIGS = {
    "fast_3ch_2sub_l8_k4": dict(chans=3, subsets=2, plist=tuple(range(64)),
                                levels=8, k=4),
    "full_3ch_2sub_l8_k8": dict(chans=3, subsets=2, plist=tuple(range(64)),
                                levels=8, k=8),
    "full_3ch_3sub_l4_k8": dict(chans=3, subsets=3, plist=tuple(range(64)),
                                levels=4, k=8),
    "full_4ch_2sub_l4_k8_pca": dict(chans=4, subsets=2,
                                    plist=tuple(range(64)), levels=4, k=8,
                                    estimator="pca"),
}


def bind(libs, parent: bool) -> dict:
    fns = {k: function(libs, f"{k}_encode")
           for k in ("bc1", "bc3", "bc2", "bc4", "bc5")
           if _build.FUNCTIONS[f"{k}_encode"][0] in libs}
    if "bc7_est" in libs:
        fns["est"] = function(libs, "bc7_est_topk",
                              EST_ARGS_PARENT if parent else None)
    fns["parent"] = parent
    return fns


def bc1_call(fns, x, kw, words, err):
    k = dict(weights=bc1.PERCEPTUAL_WEIGHTS, iters=3, passes=1,
             allow_three=True, use_alpha=False, alpha_threshold=0.5,
             adaptive=False, b3d=False)
    k.update(kw)
    w = k["weights"]
    call(fns["bc1"], x, x.shape[0], x.shape[2], words, err, w[0], w[1], w[2],
         k["iters"], k["passes"], int(k["allow_three"]), int(k["use_alpha"]),
         float(k["alpha_threshold"]) * 255.0, int(k["adaptive"]),
         int(k["b3d"]))


def bc23_call(fns, which, x, kw, words, err):
    """K1b (``which`` "bc3") or K1c ("bc2") at the wrappers' defaults
    updated with ``kw``."""
    k = dict(iters=3, passes=1, adaptive=False, a_iters=3, a_radius=2,
             a_rounds=2)
    k.update(kw)
    w = bc1.PERCEPTUAL_WEIGHTS
    args = [x, x.shape[0], words, err, w[0], w[1], w[2], k["iters"],
            k["passes"], int(k["adaptive"])]
    if which == "bc3":
        args += [k["a_iters"], k["a_radius"], k["a_rounds"]]
    call(fns[which], *args)


def bc45_call(fns, which, x, kw, words, err):
    """K2a (``which`` "bc4", x (N,16)) or K2b ("bc5", x (N,16,2)) at the
    wrappers' defaults updated with ``kw``."""
    k = dict(iters=3, radius=2, rounds=2)
    k.update(kw)
    budget = (k["iters"], k["radius"], k["rounds"])
    if which == "bc4":
        call(fns["bc4"], x, x.shape[0], words, err, *budget)
    else:
        call(fns["bc5"], x, x.shape[0], x.shape[2], words, err, *budget)


def est_call(fns, x, cfg, bar, ids):
    plist = cfg["plist"]
    pl = (ctypes.c_int * len(plist))(*plist)
    args = [x, x.shape[0], cfg["chans"], cfg["subsets"], pl]
    if not fns["parent"]:
        args.append((ctypes.c_int * len(plist))(
            *bc7_est.deal_order(plist, cfg["subsets"])))
    args += [len(plist), cfg["levels"], cfg["k"],
             int(cfg.get("estimator") == "pca")]
    if not fns["parent"]:
        args.append(bar)
    elif bar is not None:
        raise ValueError("the parent's K3 takes no bar")
    call(fns["est"], *args, ids)


def blocks_of(img):
    return image_to_blocks(torch.from_numpy(img[None]).cuda())[..., :4] \
        .contiguous()


def main() -> int:
    ap = arguments(__doc__)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated parts to time, of {PARTS}")
    ap.add_argument("--lanes", default="",
                    help="comma-separated launch shapes of extra builds of "
                         "this checkout's K2a and K2b: lanes per block and "
                         "family, optionally xTHREADS per CTA (bc45 part)")
    args = ap.parse_args()
    parts = [p for p in args.parts.split(",") if p]
    if set(parts) - set(PARTS):
        ap.error(f"--parts: unknown {sorted(set(parts) - set(PARTS))}")
    smi = device()
    if smi is None:
        print("needs a CUDA device", file=sys.stderr)
        return 1
    waits = {"old": start_build(args.parent, "k1k3_old", SOURCES),
             "new": start_build(_build.CSRC, "k1k3_new", SOURCES)}
    sweep = []
    for shape in [v for v in args.lanes.split(",") if v]:
        lanes, _, threads = shape.partition("x")
        flags = [f"-DSWEEP_LANES={int(lanes)}"]
        if threads:
            flags.append(f"-DSWEEP_THREADS={int(threads)}")
        sweep.append(f"new_l{shape}")
        waits[sweep[-1]] = start_build(_build.CSRC, f"k2_l{shape}",
                                       LANE_SOURCES, flags)
    side, libs_of, resources = {}, {}, {}
    for s, wait in waits.items():
        libs_of[s], resources[s] = wait()
        side[s] = bind(libs_of[s], s == "old")
    names = ["old", "new"]
    names45 = names + sweep
    res = {"device": smi, "reps": args.reps, "order": "old new new old",
           "parts": parts, "resources": resources, "bc1": {}, "bc23": {},
           "bc45": {}, "est": {}}

    ok = True

    def timed(table, key, sides, run, n, cols, reps):
        """Every side's outputs against the old side's, then the turns of
        ``sides``; ``run(fns, words, err)`` launches one side."""
        nonlocal ok
        outs = {}
        for s in sides:
            outs[s] = (torch.empty((n, cols), dtype=torch.int32,
                                   device="cuda"),
                       torch.empty((n,), dtype=torch.float32, device="cuda"))
            run(side[s], *outs[s])
        torch.cuda.synchronize()
        differ = {s: blocks_differing(outs["old"], outs[s])
                  for s in sides[1:]}
        same = not any(differ.values())
        ok = ok and same
        o = outs["new"]
        table[key] = {
            "n_blocks": n, "equal": same, "blocks_differing": differ,
            "ms": in_turns(sides, lambda s: queued_ms(
                lambda: run(side[s], *o), reps))}
        print(json.dumps({key: table[key]}), flush=True)

    images = {"13x257": (blocks_of(photo_rgba(13, 257, seed=105)),
                         blocks_of(with_alpha_field(
                             photo_rgba(13, 257, seed=105), 3)))}
    if "k1a" in parts:
        big = photo_rgba(4096, 4096, seed=100)
        images["4096"] = (blocks_of(big),
                          blocks_of(with_alpha_field(big.copy(), 3)))
        # a warm-up of about two seconds on both sides, so that the first
        # readings do not meet the card at its idle clocks
        w = (torch.empty((big_n := images["4096"][0].shape[0], 2),
                         dtype=torch.int32, device="cuda"),
             torch.empty((big_n,), dtype=torch.float32, device="cuda"))
        for _ in range(250):
            for s in names:
                bc1_call(side[s], images["4096"][0], {}, *w)
        torch.cuda.synchronize()
        for name, kw in {**BC1_BUDGETS, **BC1_PARTS}.items():
            for size in ("4096", "13x257"):
                if name in BC1_PARTS and size != "4096":
                    continue
                opaque, alpha = images[size]
                x = alpha if kw.get("use_alpha") else opaque
                n = x.shape[0]
                reps = max(2, args.reps // 5) if kw.get("b3d") and n > 1e5 \
                    else args.reps
                timed(res["bc1"], f"{name}_{size}", names,
                      lambda f, wd, e, x=x, kw=kw: bc1_call(f, x, kw, wd, e),
                      n, 2, reps)

    if "bc23" in parts:
        # chip_smoke.py's BC3 and BC2 images
        arrays = {"bc3": with_alpha_field(photo_rgba(1024, 1024, seed=104),
                                          4),
                  "bc2": with_alpha_field(photo_rgba(1024, 1024, seed=103),
                                          3)}
        bc23_images = {k: blocks_of(a) for k, a in arrays.items()}
        # a warm-up of about a second
        for _ in range(100):
            for s in names:
                x = bc23_images["bc3"]
                bc23_call(side[s], "bc3", x, {}, *(
                    torch.empty((x.shape[0], 4), dtype=torch.int32,
                                device="cuda"),
                    torch.empty((x.shape[0],), dtype=torch.float32,
                                device="cuda")))
        torch.cuda.synchronize()
        for which, budgets in (("bc3", BC3_BUDGETS), ("bc2", BC2_BUDGETS)):
            for budget, kw in budgets.items():
                for size, x in (("1k_alpha", bc23_images[which]),
                                ("13x257", images["13x257"][1])):
                    if size == "13x257" and budget != "default":
                        continue
                    timed(res["bc23"], f"{which}_{budget}_{size}", names,
                          lambda f, wd, e, x=x, kw=kw, which=which:
                          bc23_call(f, which, x, kw, wd, e),
                          x.shape[0], 4, args.reps)
        # as compress() runs them: the kernel right after image_to_blocks,
        # and the whole call with the port's launches routed through each
        # side's library
        ctypes_of = {"bc3": gic.CompressType.DXBC3,
                     "bc2": gic.CompressType.DXBC2}
        for which, arr in arrays.items():
            t = torch.from_numpy(arr[None]).cuda()
            x = bc23_images[which]
            o = (torch.empty((x.shape[0], 4), dtype=torch.int32,
                             device="cuda"),
                 torch.empty((x.shape[0],), dtype=torch.float32,
                             device="cuda"))
            res["bc23"][f"{which}_default_1k_alpha_after_blocks"] = {
                "ms": in_turns(names, lambda s, t=t, x=x, o=o, which=which:
                               launch_ms(lambda: image_to_blocks(t),
                                         lambda: bc23_call(side[s], which, x,
                                                           {}, *o),
                                         args.reps))}
            img = gic.Image.from_array(np.ascontiguousarray(arr[None]))
            outs = {}
            for s in names:
                with port_libraries({"bc23": libs_of[s]["bc23"]}):
                    outs[s] = (gic.compress(ctypes_of[which], img)
                               .blocks.reshape(-1, 4),)
            torch.cuda.synchronize()
            differ = blocks_differing(outs["old"], outs["new"])
            ok = ok and differ == 0

            def compress_ms(s, img=img, which=which):
                with port_libraries({"bc23": libs_of[s]["bc23"]}):
                    return time_ms(lambda: gic.compress(ctypes_of[which],
                                                        img), args.reps)
            res["bc23"][f"compress_{which}_1k"] = {
                "blocks_differing": differ,
                "ms": in_turns(names, compress_ms)}
            print(json.dumps({f"compress_{which}_1k":
                              res["bc23"][f"compress_{which}_1k"]}),
                  flush=True)

    if "bc45" in parts:
        # chip_smoke.py's BC4 and BC5 images, the 13x257 photo, and the
        # large images
        arrays = {
            "bc4_512": photo_rgba(512, 512, seed=101)[None, ..., :1],
            "bc5_512": photo_rgba(512, 512, seed=102)[None, ..., :2],
            "bc4_13x257": photo_rgba(13, 257, seed=105)[None, ..., :1],
            "bc5_13x257": photo_rgba(13, 257, seed=105)[None, ..., :2],
            "bc4_4096": photo_rgba(4096, 4096, seed=100)[None, ..., :1],
            "bc5_2048": photo_rgba(2048, 2048, seed=106)[None, ..., :2]}

        def bc45_input(which, t):
            """The kernel's input as compress() makes it from the image."""
            b = image_to_blocks(t)
            return b[:, :, 0].contiguous() if which == "bc4" else b

        tensors = {k: torch.from_numpy(np.ascontiguousarray(a)).cuda()
                   for k, a in arrays.items()}
        # a warm-up of about a second on every side
        x = bc45_input("bc5", tensors["bc5_2048"])
        o = (torch.empty((x.shape[0], 4), dtype=torch.int32, device="cuda"),
             torch.empty((x.shape[0],), dtype=torch.float32, device="cuda"))
        for _ in range(20):
            for s in names45:
                bc45_call(side[s], "bc5", x, {}, *o)
        torch.cuda.synchronize()
        for label, t in tensors.items():
            which = label[:3]
            x = bc45_input(which, t)
            budgets = BC45_BUDGETS if label.endswith("_512") else \
                {"default": {}}
            for budget, kw in budgets.items():
                timed(res["bc45"], f"{label}_{budget}", names45,
                      lambda f, wd, e, x=x, kw=kw, which=which:
                      bc45_call(f, which, x, kw, wd, e),
                      x.shape[0], 2 if which == "bc4" else 4,
                      max(2, args.reps // 5) if x.shape[0] > 5e5
                      else args.reps)
        # as compress() runs them at 512x512: the kernel right after
        # image_to_blocks, and the whole call with the port's launches
        # routed through each side's library
        ctypes_of = {"bc4": gic.CompressType.DXBC4,
                     "bc5": gic.CompressType.DXBC5}
        for which in ("bc4", "bc5"):
            t = tensors[f"{which}_512"]
            x = bc45_input(which, t)
            o = (torch.empty((x.shape[0], 2 if which == "bc4" else 4),
                             dtype=torch.int32, device="cuda"),
                 torch.empty((x.shape[0],), dtype=torch.float32,
                             device="cuda"))
            key = f"{which}_512_after_blocks"
            res["bc45"][key] = {
                "ms": in_turns(names45, lambda s, t=t, x=x, o=o, which=which:
                               launch_ms(lambda: bc45_input(which, t),
                                         lambda: bc45_call(side[s], which, x,
                                                           {}, *o),
                                         args.reps))}
            print(json.dumps({key: res["bc45"][key]}), flush=True)
            img = gic.Image.from_array(np.ascontiguousarray(
                arrays[f"{which}_512"]))
            outs = {}
            for s in names45:
                with port_libraries({"bc45": libs_of[s]["bc45"]}):
                    outs[s] = (gic.compress(ctypes_of[which], img)
                               .blocks.reshape(x.shape[0], -1),)
            torch.cuda.synchronize()
            differ = {s: blocks_differing(outs["old"], outs[s])
                      for s in names45[1:]}
            ok = ok and not any(differ.values())

            def compress_ms(s, img=img, which=which):
                with port_libraries({"bc45": libs_of[s]["bc45"]}):
                    return time_ms(lambda: gic.compress(ctypes_of[which],
                                                        img), args.reps)
            key = f"compress_{which}_512"
            res["bc45"][key] = {"blocks_differing": differ,
                                "ms": in_turns(names45, compress_ms)}
            print(json.dumps({key: res["bc45"][key]}), flush=True)

    if "k3" in parts:
        photo = photo_rgba(1024, 1024, seed=110)
        est_images = {"1k": blocks_of(photo),
                      "1k_alpha": blocks_of(with_alpha_field(photo.copy(),
                                                             6)),
                      "13x257": blocks_of(photo_rgba(13, 257, seed=113))}
        for cname, cfg in EST_CONFIGS.items():
            for iname, x in est_images.items():
                n, k = x.shape[0], cfg["k"]
                bar = bc7_full._combined_alpha_bar(x, True, True)
                ids = {s: torch.empty((n, k), dtype=torch.int32,
                                      device="cuda")
                       for s in ("old", "new", "new_bar")}
                est_call(side["old"], x, cfg, None, ids["old"])
                est_call(side["new"], x, cfg, None, ids["new"])
                est_call(side["new"], x, cfg, bar, ids["new_bar"])
                torch.cuda.synchronize()
                first = torch.tensor(cfg["plist"][:k], dtype=torch.int32,
                                     device="cuda")
                same = bool(torch.equal(ids["old"], ids["new"])
                            and torch.equal(ids["old"][~bar],
                                            ids["new_bar"][~bar])
                            and (ids["new_bar"][bar] == first).all().item())
                ok = ok and same
                o = torch.empty((n, k), dtype=torch.int32, device="cuda")
                res["est"][f"{cname}_{iname}"] = {
                    "n_blocks": n, "barred_frac": bar.double().mean().item(),
                    "equal": same,
                    "ms": in_turns(names, lambda s, x=x, cfg=cfg: queued_ms(
                        lambda: est_call(side[s], x, cfg, None, o),
                        args.reps)),
                    "ms_bar": in_turns(names, lambda s, x=x, cfg=cfg, bar=bar:
                                       queued_ms(lambda: est_call(
                                           side[s], x, cfg,
                                           None if s == "old" else bar, o),
                                           args.reps))}
    return finish(res, args.out, ok)


if __name__ == "__main__":
    sys.exit(main())
