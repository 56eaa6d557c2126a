"""Times the BC6H search (K6) and the fast BC7 search (K4) of this checkout
against those of another copy of the port's ``csrc/`` (``--parent``), on the
same blocks, on one card, in turns (``torch_turns.py``: the build side by
side, the turns, the comparison).

Both sides are built from their own sources (``bc6h_kernel.cu`` and
``bc7_fast_kernel.cu``) and called through their C functions,
``bc6h_encode`` and ``bc7_fast_encode``, which take the same arguments on
both sides. ``--lanes 8,16`` adds builds of this checkout at other numbers of
lanes per block (``torch_lanes_bc6h.cu`` and ``torch_lanes_bc7_fast.cu``:
the same templates and C functions at ``-DSWEEP_LANES=n``), timed beside the
other two. Every measurement is CUDA events around launches queued behind a
device-side sleep (``chip_smoke.queued_ms``), after a warm-up call:

- K6 at the four quality tiers (1.0, 0.8, 0.7, 0.3), unsigned and signed,
  on ``chip_smoke.py``'s 1024x1024 HDR photo (65,536 blocks; the signed one
  with its green channel negated) and on the 13x257 HDR photo (unsigned);
  and once more at 1024x1024 launched right after the half conversion
  (``chip_smoke.launch_ms``), as ``compress()`` runs it: L2 state moves K6's
  time;
- K4 at the default budget (64 partitions, top 4, uber 4, perceptual), the
  ``fast`` budget (24 partitions, top 2, uber 0) and the RGB metric on the
  1024x1024 photo, at the default budget on the same photo with an alpha
  field (mode 6 only) and on the 13x257 photo; the partition ids come from
  this checkout's shortlist kernel (K3), the same ids for every side.

Words and errors of every side are compared with the first side's on every
block (they must be equal: each equals its plain version bit for bit). The
registers and spills of every build are reported from ``ptxas -v``. Needs a
CUDA device. From the root of the repo:

    python3 scripts/torch_bc6h_bc7fast_timing.py --parent DIR \
        [--lanes 8,16] [--out results.json]
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from torch_turns import (ROOT, arguments, blocks_differing, call,
                         device, finish, function, in_turns, start_build)
from chip_smoke import (launch_ms, photo_rgba, queued_ms,
                        with_alpha_field)
import gfx_imagecompress_tpu_torch as gic
from gfx_imagecompress_tpu_torch.kernels import (
    _build, bc6h, bc7_est, bc7_fast)
from gfx_imagecompress_tpu_torch.pipeline.blocks import (
    image_to_blocks)

TIERS = (1.0, 0.8, 0.7, 0.3)
FAST_BUDGETS = {"default": {}, "fast": {"fast": True},
                "rgb_metric": {"perceptual": False}}
SOURCES = {"bc6h": "bc6h_kernel.cu", "bc7_fast": "bc7_fast_kernel.cu"}
LANE_SOURCES = {"bc6h": ROOT / "scripts" / "torch_lanes_bc6h.cu",
                "bc7_fast": ROOT / "scripts" / "torch_lanes_bc7_fast.cu"}


def k6_call(fns, h, sg, q, words, err):
    topk, iters, shake = bc6h._budgets(q)
    call(fns["bc6h"], h, h.shape[0], int(sg), topk, iters, shake, 0xFFFF, -1,
         words, err)


def k4_call(fns, x, ids, perceptual, uber, words, err):
    call(fns["bc7_fast"], x, x.shape[0], ids, ids.shape[1], int(perceptual),
         uber, words, err)


def main() -> int:
    ap = arguments(__doc__)
    ap.add_argument("--lanes", default="",
                    help="comma-separated lane counts of extra builds of "
                         "this checkout")
    args = ap.parse_args()
    smi = device()
    if smi is None:
        print("needs a CUDA device", file=sys.stderr)
        return 1
    waits = {"old": start_build(args.parent, "k4k6_old", SOURCES),
             "new": start_build(_build.CSRC, "k4k6_new", SOURCES)}
    for n in [int(v) for v in args.lanes.split(",") if v]:
        waits[f"new_l{n}"] = start_build(_build.CSRC, f"k4k6_new_l{n}",
                                         LANE_SOURCES, [f"-DSWEEP_LANES={n}"])
    _build.ensure_built()          # this checkout's K3, for the ids
    side, resources = {}, {}
    for name, wait in waits.items():
        libs, resources[name] = wait()
        side[name] = {"bc6h": function(libs, "bc6h_encode"),
                      "bc7_fast": function(libs, "bc7_fast_encode")}
    names = list(side)
    res = {"device": smi, "reps": args.reps,
           "order": " ".join(names + names[::-1]), "resources": resources,
           "bc6h": {}, "bc7_fast": {}}

    def same_outputs(run, n, key):
        """Every side's words and errors against the first side's."""
        outs = {}
        for s in names:
            outs[s] = (torch.empty((n, 4), dtype=torch.int32, device="cuda"),
                       torch.empty((n,), dtype=torch.float32, device="cuda"))
            run(side[s], *outs[s])
        torch.cuda.synchronize()
        for s in names[1:]:
            if bad := blocks_differing(outs[names[0]], outs[s]):
                raise RuntimeError(f"{key}: side {s} differs from {names[0]} "
                                   f"on {bad} of {n} blocks")

    def record(table, key, t, n):
        mean = {s: float(np.mean(v)) for s, v in t.items()}
        row = {"blocks": n, **t,
               **{f"ratio_old_over_{s}": mean["old"] / mean[s]
                  for s in names[1:]}}
        table[key] = row
        print(json.dumps({key: row}), flush=True)

    # ---- K6
    def hdr_blocks(rgb, signed):
        a = np.ones(rgb.shape[:-1] + (1,), np.float32)
        arr = np.concatenate([rgb, a], -1).astype(np.float16)[None]
        img = gic.Image.from_array(np.ascontiguousarray(arr), signed=signed,
                                   hdr=True)
        return image_to_blocks(img.data)[:, :, :3].contiguous()

    photo = np.exp(photo_rgba(1024, 1024, seed=120)[..., :3] * 4.0)
    signed_photo = photo.copy()
    signed_photo[..., 1] *= -1.0
    k6_inputs = {
        "1k_unsigned": (hdr_blocks(photo, False), False),
        "1k_signed": (hdr_blocks(signed_photo, True), True),
        "13x257_unsigned": (hdr_blocks(np.exp(
            photo_rgba(13, 257, seed=121)[..., :3] * 4.0), False), False),
    }
    for label, (x, sg) in k6_inputs.items():
        h = bc6h.f32_to_half_int(x, sg).contiguous()
        n = h.shape[0]
        words = torch.empty((n, 4), dtype=torch.int32, device="cuda")
        err = torch.empty((n,), dtype=torch.float32, device="cuda")
        reps = args.reps if n > 10_000 else 10 * args.reps
        for q in TIERS:
            key = f"{label}_q{q}"
            same_outputs(lambda f, w, e: k6_call(f, h, sg, q, w, e), n, key)
            record(res["bc6h"], key, in_turns(names, lambda s: queued_ms(
                lambda: k6_call(side[s], h, sg, q, words, err), reps)), n)
            if n > 10_000:
                hc = [h]

                def convert(x=x, sg=sg):
                    hc[0] = bc6h.f32_to_half_int(x, sg).contiguous()

                record(res["bc6h"], f"{key}_after_conversion",
                       in_turns(names, lambda s: launch_ms(
                           convert, lambda: k6_call(side[s], hc[0], sg, q,
                                                    words, err), reps)), n)

    # ---- K4
    def rgba_blocks(img):
        return image_to_blocks(torch.from_numpy(img[None]).cuda())[..., :4] \
            .contiguous()

    k4_inputs = {
        "1k": rgba_blocks(photo_rgba(1024, 1024, seed=110)),
        "1k_alpha": rgba_blocks(with_alpha_field(
            photo_rgba(1024, 1024, seed=112), 6)),
        "13x257": rgba_blocks(photo_rgba(13, 257, seed=113)),
    }
    work = [("1k", b) for b in FAST_BUDGETS] + [("1k_alpha", "default"),
                                                ("13x257", "default")]
    for label, budget in work:
        x = k4_inputs[label]
        kw = FAST_BUDGETS[budget]
        plist, topk, uber = bc7_fast._budget(kw.get("fast", False), None,
                                             None, None)
        ids = bc7_est.estimate_topk(x, chans=3, subsets=2, plist=plist,
                                    levels=8, k=topk)
        perc = kw.get("perceptual", True)
        n = x.shape[0]
        words = torch.empty((n, 4), dtype=torch.int32, device="cuda")
        err = torch.empty((n,), dtype=torch.float32, device="cuda")
        reps = args.reps if n > 10_000 else 10 * args.reps
        key = f"{label}_{budget}"
        same_outputs(lambda f, w, e: k4_call(f, x, ids, perc, uber, w, e), n,
                     key)
        record(res["bc7_fast"], key, in_turns(names, lambda s: queued_ms(
            lambda: k4_call(side[s], x, ids, perc, uber, words, err), reps)),
            n)

    print(json.dumps({"resources": resources}))
    return finish(res, args.out, True)


if __name__ == "__main__":
    sys.exit(main())
