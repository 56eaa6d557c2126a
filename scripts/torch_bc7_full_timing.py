"""Times the full BC7 search (K5) of this checkout against the K5 of another
checkout of the repo (``--parent``, for example an earlier commit unpacked
with ``git archive``), on the same blocks, on one card, in turns.

Both K5s are built here from their own sources with the port's nvcc flags and
called through their C functions (``bc7_full_m02``, ``bc7_full_m1367``,
``bc7_full_m45``: the same signature in both). The shortlists come from this
checkout's K3 and are the same for both. Each measurement is taken as old,
new, new, old (the two readings of each side are reported), per budget tier
of ``compress(DXBC7)``: the search budgets that ``bc7_full._plan`` gives for
quality 1.0, 0.5 and 0.25 and for performance 0.3 (``TIERS``):

- ``path_1k``: the eight mode launches of one ``compress(DXBC7)`` chunk of the
  1024x1024 photo of ``chip_smoke.py`` (65,536 blocks), each iteration right
  after the chunk's shortlist launches, as the main path runs them (the
  shortlists not timed);
- ``mode_1k``: each mode alone, back to back (what a ``mode_mask`` of one
  mode runs);
- at quality 1.0 only, ``alone_1k``: the eight launches back to back on
  shortlists computed once; and ``path_13x257``: the eight launches on the
  260 blocks of the 13x257 photo, after their shortlists.

Both K5s' words and errors are compared on the 1K blocks at every tier (they
must be equal: each equals its plain version bit for bit). Needs a CUDA
device. From the root of the repo:

    python3 scripts/torch_bc7_full_timing.py --parent DIR [--out results.json]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import launch_ms, photo_rgba, time_ms  # noqa: E402
from gfx_imagecompress_tpu_torch.kernels import (  # noqa: E402
    _build, bc7_est, bc7_full)
from gfx_imagecompress_tpu_torch.pipeline.blocks import (  # noqa: E402
    image_to_blocks)

LIBS = ("bc7_full_m02", "bc7_full_m1367", "bc7_full_m45")


def build_k5(root: Path, out: Path) -> tuple:
    """nvcc the three K5 sources under ``root`` into ``out``, side by side;
    returns C function name -> ctypes function, and the ptxas logs."""
    csrc = root / "gfx_imagecompress_tpu_torch" / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lib in LIBS:
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(out / f"{lib}.so"), str(csrc / f"{lib}_kernel.cu")]
        procs[lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    fns, logs = {}, {}
    for lib, proc in procs.items():
        logs[lib], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {root}/{lib}:\n{logs[lib]}")
        fn = getattr(ctypes.CDLL(str(out / f"{lib}.so")), lib)
        fn.argtypes = [*_build.FUNCTIONS[lib][1], ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[lib] = fn
    return fns, logs


def launch(fns, x, mode, plan, bar, ids, merge, words, err):
    """One mode's search through the C functions ``fns``, on the current
    stream."""
    ids_p, nids = None, 0
    if isinstance(ids, int):
        nids = ids
    elif ids is not None:
        ids_p, nids = ids.data_ptr(), ids.shape[1]
    rc = fns[bc7_full.MODE_FUNCTIONS[mode]](
        x.data_ptr(), x.shape[0], mode, ids_p, nids, plan.iters, plan.shake,
        plan.uber, plan.keep, bar.data_ptr() if mode >= 6 else None,
        int(merge), words.data_ptr(), err.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"mode {mode}: launch failed ({rc})")


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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout (the old K5)")
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
    _build.ensure_built()
    side = {"old": build_k5(Path(args.parent).resolve(),
                            root / "build" / "k5_old"),
            "new": build_k5(root, root / "build" / "k5_new")}
    res = {"device": smi, "reps": args.reps, "order": "old new new old",
           "tiers": {}}

    def turns(measure):
        out = {"old": [], "new": []}
        for s in ("old", "new", "new", "old"):
            out[s].append(measure(side[s][0]))
        return out

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
        wo, eo = searches(side["old"][0], x, plan, bar, ids_of)
        wn, en = searches(side["new"][0], x, plan, bar, ids_of)
        torch.cuda.synchronize()
        t = {"budget": [plan.iters, plan.shake, plan.uber, plan.keep],
             "n_blocks_1k": int(x.shape[0]),
             "words_equal_frac": (wo == wn).all(1).double().mean().item(),
             "errors_equal": bool(torch.equal(eo, en))}
        ok = ok and t["words_equal_frac"] == 1.0 and t["errors_equal"]
        t["path_1k"] = turns(lambda f: launch_ms(
            shortlists, lambda: searches(f, x, plan, bar, ids_of),
            args.reps))
        t["mode_1k"] = {m: turns(lambda f, m=m: time_ms(
            lambda: one_mode(f, x, plan, bar, ids_of, m), args.reps))
            for m in plan.modes}
        if tier == "q1":
            t["alone_1k"] = turns(lambda f: time_ms(
                lambda: searches(f, x, plan, bar, ids_of), args.reps))
            xs, bars, shorts, ids_s = setup(photo_rgba(13, 257, seed=113),
                                            plan)
            t["n_blocks_13x257"] = int(xs.shape[0])
            t["path_13x257"] = turns(lambda f: launch_ms(
                shorts, lambda: searches(f, xs, plan, bars, ids_s),
                args.reps))
        res["tiers"][tier] = t
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
