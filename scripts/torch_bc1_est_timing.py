"""Times the BC1 kernel (K1a), the BC3 and BC2 kernels (K1b, K1c, whose
colour half shares K1a's per-candidate helpers) and the BC7 partition
shortlist (K3) of this checkout against those of another copy of the port's
``csrc/`` (``--parent``), on the same blocks, on one card, in turns
(``torch_turns.py``: the build side by side, the turns, the comparison).

Both sides are built from their own sources (``bc1_kernel.cu``,
``bc23_kernels.cu`` and ``bc7_est_kernel.cu``) and called through their C
functions: ``bc1_encode``, ``bc3_encode``
and ``bc2_encode`` have one signature in both; this checkout's
``bc7_est_topk`` also takes the order in which the partitions are dealt to
its lanes and a per-block bar; the parent's is taken to be the one-thread
design's, which takes neither. Each measurement is taken as old, new, new,
old (both readings of each side are reported), CUDA events around
launches queued behind a device-side sleep (``chip_smoke.queued_ms``), so
that the host's launch cost does not show, after a warm-up call (and,
before the first, about two seconds of K1a on both sides):

- K1a at ``chip_smoke.py``'s six BC1 budgets (default, use_alpha,
  four_only, adaptive, b3d, b3d_use_alpha), on the 4096x4096 photo of
  ``chip_smoke.py`` (1,048,576 blocks; with an alpha field for the
  punch-through budgets) and on the 13x257 photo (260 blocks); and, to see
  where its time goes, the default budget without the refine
  (``no_refine``) and without the refine and the least-squares rounds
  (``no_refine_no_lsq``), at 4096x4096;
- K1b and K1c at their default budgets on ``chip_smoke.py``'s BC3 and BC2
  images (1024x1024 photos with an alpha field, 65,536 blocks) and on the
  13x257 photo with an alpha field;
- K3 at its four configurations on the main paths (the fast path's
  (3 channels, 2 subsets, 64 partitions, 8 levels, k 4) and the full path's
  three: (3, 2, 64, 8, k 8), (3, 3, 64, 4, k 8), (4, 2, 64, 4, k 8, PCA)), on
  the 1024x1024 photo (65,536 blocks), the same photo with an alpha field,
  and the 13x257 photo; the new side without the bar and with the full BC7
  entry's mode 6/7 bar of that image (the old side has no bar).

Words, errors and ids of both sides are compared wherever both rank every
block (they must be equal: each equals its plain version bit for bit); with
the bar, the new side's ids are compared with the old side's on the blocks
that are not barred. Needs a CUDA device. From the root of the repo:

    python3 scripts/torch_bc1_est_timing.py --parent DIR [--out results.json]
"""
from __future__ import annotations

import ctypes
import sys

import torch

from torch_turns import (arguments, call, device, finish, function, in_turns,
                         start_build)
from chip_smoke import photo_rgba, queued_ms, with_alpha_field
from gfx_imagecompress_tpu_torch.kernels import _build, bc1, bc7_est, bc7_full
from gfx_imagecompress_tpu_torch.pipeline.blocks import image_to_blocks

P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# bc7_est_topk of the one-thread K3, the parent's design: no deal order, no bar
EST_ARGS_PARENT = (P, LL, I, I, P, I, I, I, I, P)
SOURCES = {"bc1": "bc1_kernel.cu", "bc23": "bc23_kernels.cu",
           "bc7_est": "bc7_est_kernel.cu"}

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
    fns = {k: function(libs, f"{k}_encode") for k in ("bc1", "bc3", "bc2")}
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


def bc23_call(fns, which, x, words, err):
    """K1b (``which`` "bc3") or K1c ("bc2") at the wrappers' defaults."""
    w = bc1.PERCEPTUAL_WEIGHTS
    args = [x, x.shape[0], words, err, w[0], w[1], w[2], 3, 1, 0]
    if which == "bc3":
        args += [3, 2, 2]
    call(fns[which], *args)


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
    args = arguments(__doc__).parse_args()
    smi = device()
    if smi is None:
        print("needs a CUDA device", file=sys.stderr)
        return 1
    waits = {"old": start_build(args.parent, "k1k3_old", SOURCES),
             "new": start_build(_build.CSRC, "k1k3_new", SOURCES)}
    side, resources = {}, {}
    for s, wait in waits.items():
        libs, resources[s] = wait()
        side[s] = bind(libs, s == "old")
    names = list(side)
    res = {"device": smi, "reps": args.reps, "order": "old new new old",
           "resources": resources, "bc1": {}, "bc23": {}, "est": {}}

    ok = True
    big = photo_rgba(4096, 4096, seed=100)
    images = {"4096": (blocks_of(big),
                       blocks_of(with_alpha_field(big.copy(), 3))),
              "13x257": (blocks_of(photo_rgba(13, 257, seed=105)),
                         blocks_of(with_alpha_field(
                             photo_rgba(13, 257, seed=105), 3)))}
    # a warm-up of about two seconds on both sides, so that the first
    # readings do not meet the card at its idle clocks
    w = (torch.empty((big_n := images["4096"][0].shape[0], 2),
                     dtype=torch.int32, device="cuda"),
         torch.empty((big_n,), dtype=torch.float32, device="cuda"))
    for _ in range(250):
        for s in side:
            bc1_call(side[s], images["4096"][0], {}, *w)
    torch.cuda.synchronize()
    for name, kw in {**BC1_BUDGETS, **BC1_PARTS}.items():
        for size, (opaque, alpha) in images.items():
            if name in BC1_PARTS and size != "4096":
                continue
            x = alpha if kw.get("use_alpha") else opaque
            n = x.shape[0]
            out = {s: (torch.empty((n, 2), dtype=torch.int32, device="cuda"),
                       torch.empty((n,), dtype=torch.float32, device="cuda"))
                   for s in side}
            for s in side:
                bc1_call(side[s], x, kw, *out[s])
            torch.cuda.synchronize()
            same = bool(torch.equal(out["old"][0], out["new"][0])
                        and torch.equal(out["old"][1], out["new"][1]))
            ok = ok and same
            reps = max(2, args.reps // 5) if kw.get("b3d") and n > 1e5 \
                else args.reps
            res["bc1"][f"{name}_{size}"] = {
                "n_blocks": n, "equal": same,
                "ms": in_turns(names, lambda s, x=x, kw=kw, o=out["new"]:
                               queued_ms(lambda: bc1_call(side[s], x, kw, *o),
                                         reps))}

    # chip_smoke.py's BC3 and BC2 images
    bc23_images = {"bc3": blocks_of(with_alpha_field(
        photo_rgba(1024, 1024, seed=104), 4)),
        "bc2": blocks_of(with_alpha_field(
            photo_rgba(1024, 1024, seed=103), 3))}
    for which in ("bc3", "bc2"):
        for size, x in (("1k_alpha", bc23_images[which]),
                        ("13x257", images["13x257"][1])):
            n = x.shape[0]
            out = {s: (torch.empty((n, 4), dtype=torch.int32, device="cuda"),
                       torch.empty((n,), dtype=torch.float32, device="cuda"))
                   for s in side}
            for s in side:
                bc23_call(side[s], which, x, *out[s])
            torch.cuda.synchronize()
            same = bool(torch.equal(out["old"][0], out["new"][0])
                        and torch.equal(out["old"][1], out["new"][1]))
            ok = ok and same
            res["bc23"][f"{which}_{size}"] = {
                "n_blocks": n, "equal": same,
                "ms": in_turns(names, lambda s, x=x, which=which, o=out["new"]:
                               queued_ms(lambda: bc23_call(side[s], which, x,
                                                           *o), args.reps))}

    photo = photo_rgba(1024, 1024, seed=110)
    est_images = {"1k": blocks_of(photo),
                  "1k_alpha": blocks_of(with_alpha_field(photo.copy(), 6)),
                  "13x257": blocks_of(photo_rgba(13, 257, seed=113))}
    for cname, cfg in EST_CONFIGS.items():
        for iname, x in est_images.items():
            n, k = x.shape[0], cfg["k"]
            bar = bc7_full._combined_alpha_bar(x, True, True)
            ids = {s: torch.empty((n, k), dtype=torch.int32, device="cuda")
                   for s in ("old", "new", "new_bar")}
            est_call(side["old"], x, cfg, None, ids["old"])
            est_call(side["new"], x, cfg, None, ids["new"])
            est_call(side["new"], x, cfg, bar, ids["new_bar"])
            torch.cuda.synchronize()
            first = torch.tensor(cfg["plist"][:k], dtype=torch.int32,
                                 device="cuda")
            same = bool(torch.equal(ids["old"], ids["new"])
                        and torch.equal(ids["old"][~bar], ids["new_bar"][~bar])
                        and (ids["new_bar"][bar] == first).all().item())
            ok = ok and same
            o = torch.empty((n, k), dtype=torch.int32, device="cuda")
            res["est"][f"{cname}_{iname}"] = {
                "n_blocks": n, "barred_frac": bar.double().mean().item(),
                "equal": same,
                "ms": in_turns(names, lambda s, x=x, cfg=cfg: queued_ms(
                    lambda: est_call(side[s], x, cfg, None, o), args.reps)),
                "ms_bar": in_turns(names, lambda s, x=x, cfg=cfg, bar=bar:
                                   queued_ms(lambda: est_call(
                                       side[s], x, cfg,
                                       None if s == "old" else bar, o),
                                       args.reps))}
    return finish(res, args.out, ok)

if __name__ == "__main__":
    sys.exit(main())
