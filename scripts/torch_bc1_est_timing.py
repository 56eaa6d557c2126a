"""Times the BC1 kernel (K1a), the BC3 and BC2 kernels (K1b, K1c, whose
colour half shares K1a's per-candidate helpers) and the BC7 partition
shortlist (K3) of this checkout against those of another copy of the port's ``csrc/`` (``--parent``,
for example an earlier commit's ``gfx_imagecompress_tpu_torch/csrc`` unpacked
with ``git archive``), on the same blocks, on one card, in turns.

Both sides are built here from their own sources with the port's nvcc flags
(``bc1_kernel.cu``, ``bc23_kernels.cu`` and ``bc7_est_kernel.cu``, side by
side) and called through their C functions: ``bc1_encode``, ``bc3_encode``
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

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import (photo_rgba, queued_ms,  # noqa: E402
                        with_alpha_field)
from gfx_imagecompress_tpu_torch.kernels import (  # noqa: E402
    _build, bc1, bc7_est, bc7_full)
from gfx_imagecompress_tpu_torch.pipeline.blocks import (  # noqa: E402
    image_to_blocks)

P, LL, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
BC1_ARGS = (P, LL, I, P, P, F, F, F, I, I, I, I, F, I, I, P)
BC3_ARGS = (P, LL, P, P, F, F, F, I, I, I, I, I, I, P)
BC2_ARGS = (P, LL, P, P, F, F, F, I, I, I, P)
EST_ARGS_PARENT = (P, LL, I, I, P, I, I, I, I, P, P)
EST_ARGS = (P, LL, I, I, P, P, I, I, I, I, P, P, P)

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


def build(csrc: Path, out: Path, parent: bool) -> tuple:
    """nvcc K1a, K1b/K1c and K3 under ``csrc`` into ``out``, side by side;
    returns the C functions and the ptxas logs."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lib, src in (("bc1", "bc1_kernel.cu"), ("bc23", "bc23_kernels.cu"),
                     ("bc7_est", "bc7_est_kernel.cu")):
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(out / f"{lib}.so"), str(csrc / src)]
        procs[lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    logs = {}
    for lib, proc in procs.items():
        logs[lib], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc}/{lib}:\n{logs[lib]}")
    enc = ctypes.CDLL(str(out / "bc1.so")).bc1_encode
    enc.argtypes, enc.restype = BC1_ARGS, I
    bc23 = ctypes.CDLL(str(out / "bc23.so"))
    bc3, bc2 = bc23.bc3_encode, bc23.bc2_encode
    bc3.argtypes, bc3.restype = BC3_ARGS, I
    bc2.argtypes, bc2.restype = BC2_ARGS, I
    est = ctypes.CDLL(str(out / "bc7_est.so")).bc7_est_topk
    est.argtypes, est.restype = (EST_ARGS_PARENT if parent else EST_ARGS), I
    return {"bc1": enc, "bc3": bc3, "bc2": bc2, "est": est,
            "parent": parent}, logs


def bc1_call(fns, x, kw, words, err):
    k = dict(weights=bc1.PERCEPTUAL_WEIGHTS, iters=3, passes=1,
             allow_three=True, use_alpha=False, alpha_threshold=0.5,
             adaptive=False, b3d=False)
    k.update(kw)
    w = k["weights"]
    rc = fns["bc1"](x.data_ptr(), x.shape[0], x.shape[2], words.data_ptr(),
                    err.data_ptr(), w[0], w[1], w[2], k["iters"], k["passes"],
                    int(k["allow_three"]), int(k["use_alpha"]),
                    float(k["alpha_threshold"]) * 255.0, int(k["adaptive"]),
                    int(k["b3d"]), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"bc1_encode failed ({rc})")


def bc23_call(fns, which, x, words, err):
    """K1b (``which`` "bc3") or K1c ("bc2") at the wrappers' defaults."""
    w = bc1.PERCEPTUAL_WEIGHTS
    args = [x.data_ptr(), x.shape[0], words.data_ptr(), err.data_ptr(),
            w[0], w[1], w[2], 3, 1, 0]
    if which == "bc3":
        args += [3, 2, 2]
    rc = fns[which](*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{which}_encode failed ({rc})")


def est_call(fns, x, cfg, bar, ids):
    plist = cfg["plist"]
    pl = (ctypes.c_int * len(plist))(*plist)
    args = [x.data_ptr(), x.shape[0], cfg["chans"], cfg["subsets"], pl]
    if not fns["parent"]:
        args.append((ctypes.c_int * len(plist))(
            *bc7_est.deal_order(plist, cfg["subsets"])))
    args += [len(plist), cfg["levels"], cfg["k"],
             int(cfg.get("estimator") == "pca")]
    if not fns["parent"]:
        args.append(None if bar is None else bar.data_ptr())
    elif bar is not None:
        raise ValueError("the parent's K3 takes no bar")
    rc = fns["est"](*args, ids.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"bc7_est_topk failed ({rc})")


def blocks_of(img):
    return image_to_blocks(torch.from_numpy(img[None]).cuda())[..., :4] \
        .contiguous()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the other copy of gfx_imagecompress_tpu_torch/csrc")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent.parent
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    side = {"old": build(Path(args.parent).resolve(),
                         root / "build" / "k1k3_old", True),
            "new": build(_build.CSRC, root / "build" / "k1k3_new", False)}
    res = {"device": smi, "reps": args.reps, "order": "old new new old",
           "bc1": {}, "bc23": {}, "est": {}}

    def turns(measure, old=None, new=None):
        out = {"old": [], "new": []}
        for s in ("old", "new", "new", "old"):
            out[s].append(measure(side[s][0], old if s == "old" else new))
        return out

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
            bc1_call(side[s][0], images["4096"][0], {}, *w)
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
                bc1_call(side[s][0], x, kw, *out[s])
            torch.cuda.synchronize()
            same = bool(torch.equal(out["old"][0], out["new"][0])
                        and torch.equal(out["old"][1], out["new"][1]))
            ok = ok and same
            reps = max(2, args.reps // 5) if kw.get("b3d") and n > 1e5 \
                else args.reps
            res["bc1"][f"{name}_{size}"] = {
                "n_blocks": n, "equal": same,
                "ms": turns(lambda f, _o, x=x, kw=kw, o=out["new"]: queued_ms(
                    lambda: bc1_call(f, x, kw, *o), reps))}

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
                bc23_call(side[s][0], which, x, *out[s])
            torch.cuda.synchronize()
            same = bool(torch.equal(out["old"][0], out["new"][0])
                        and torch.equal(out["old"][1], out["new"][1]))
            ok = ok and same
            res["bc23"][f"{which}_{size}"] = {
                "n_blocks": n, "equal": same,
                "ms": turns(lambda f, _o, x=x, which=which, o=out["new"]:
                            queued_ms(lambda: bc23_call(f, which, x, *o),
                                      args.reps))}

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
            est_call(side["old"][0], x, cfg, None, ids["old"])
            est_call(side["new"][0], x, cfg, None, ids["new"])
            est_call(side["new"][0], x, cfg, bar, ids["new_bar"])
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
                "ms": turns(lambda f, _b, x=x, cfg=cfg: queued_ms(
                    lambda: est_call(f, x, cfg, None, o), args.reps)),
                "ms_bar": turns(lambda f, b, x=x, cfg=cfg: queued_ms(
                    lambda: est_call(f, x, cfg, b, o), args.reps),
                    old=None, new=bar)}
    res["ptxas"] = {s: side[s][1] for s in side}
    print(smi, flush=True)
    print(json.dumps({k: v for k, v in res.items() if k != "ptxas"}),
          flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
