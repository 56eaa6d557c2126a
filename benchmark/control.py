"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, at a budget that breaks one guarantee
of the configuration (``"control"`` in its file), read on the blocks a run
of the cell samples.

    python3 benchmark/control.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--textures <t>] [--device cuda]

For a bake cell, ``--textures`` is how many textures a run's window
completes (its calls are their levels, in the run's order); for a serve
cell, the requests due in ``--seconds``. Prints one JSON line per seed with
the numbers compared. The benchmark's runs never run this; it imports
nothing of the program.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from benchmark import check, spec  # noqa: E402
from benchmark.pipe import Pipe  # noqa: E402
from benchmark.record import Sample, sample_index  # noqa: E402


def calls(cell, loop, seed: int, seconds: float, textures: int) -> list:
    """(level, sampled block indices) of each call of a run, in order."""
    out = []
    if cell.mix["loop"] == "bake":
        n = len(loop.textures)
        levels = [lv for i in range(textures)
                  for lv in loop.textures[loop.order[i % n]].levels]
    else:
        levels = [loop.pool[k][j] for _, k, j in loop.sched]
    for no, lv in enumerate(levels):
        out.append((lv, sample_index(seed, no, lv.blocks)))
    return out


def readings(cell, seed: int, seconds: float, textures: int, device) -> dict:
    enc = spec.encoder(cell.config["encoder"])
    opts = enc.options(cell.config)
    ctrl = enc.options(cell.config, control=True)
    loop = spec.loop(cell.mix["loop"]).make(cell.mix, seed, Pipe(device),
                                            enc, opts, seconds)
    samples = [Sample(lv, idx, None) for lv, idx in
               calls(cell, loop, seed, seconds, textures)]
    blocks, _ = check.sampled_blocks(samples, device)
    prog = check.encode_batched(lambda b: enc.reference(b, ctrl), blocks)
    ref = check.encode_batched(lambda b: enc.reference(b, opts), blocks)
    out = check.compare(enc, blocks, prog, ref)
    out.update(seed=seed, calls=len(samples))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--textures", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, args.textures,
                                  torch.device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
