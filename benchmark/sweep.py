"""The rate sweep that places a serve cell's fixed rate: the highest rate
the program sustains on the cell's mix without a backlog that grows over
the window. Run once when a serve cell is defined; its result is written
into the mix file as a number, and the benchmark's runs never run this.

    python3 benchmark/sweep.py --workload <serve cell> --seed <n> \
        --seconds <s> --rates <r> [<r> ...]

One process: set-up once, then one window per rate, in the order given.
Prints one JSON line per rate: requests, p50 and p95 of latency in ms over
the whole window and over each half of it (by due time), the generator's
lag, and how long past the window's close the last request came
(``drain_s``). A backlog that grows shows as a second half slower than the
first and a drain of many requests' worth.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from benchmark import spec  # noqa: E402
from benchmark.loops import serve  # noqa: E402
from benchmark.pipe import Pipe  # noqa: E402
from benchmark.record import Run, percentile  # noqa: E402
from benchmark.run import program_encode  # noqa: E402


def summary(run: Run, seconds: float) -> dict:
    lat = [(it.done - it.due) * 1e3 for it in run.items if it.done is not None]
    half = [[(it.done - it.due) * 1e3 for it in run.items
             if it.done is not None and (it.due < seconds / 2) == first]
            for first in (True, False)]
    done = [it.done for it in run.items if it.done is not None]
    return {"requests": len(run.items), "completed": len(lat),
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "p95_first_half_ms": percentile(half[0], 95),
            "p95_second_half_ms": percentile(half[1], 95),
            "p50_first_half_ms": percentile(half[0], 50),
            "p50_second_half_ms": percentile(half[1], 50),
            "lag_p95_ms": percentile([(it.issued - it.due) * 1e3
                                      for it in run.items], 95),
            "drain_s": max(done) - seconds if done else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    enc = spec.encoder(cell.config["encoder"])
    opts = enc.options(cell.config)
    encode = program_encode(enc.FAST, device)
    pipe = Pipe(device)
    loop = serve.Serve(cell.mix, args.seed, pipe, enc, opts, args.seconds)
    loop.warm(encode)
    for rate in args.rates:
        mix = dict(cell.mix, rate_per_s=rate)
        loop.sched = serve.schedule(mix, args.seed, args.seconds)
        loop.first = 0                    # no PSNR: every request on a ring
        run = Run(cell.name, args.seed, args.seconds)
        loop.window(encode, args.seconds, run)
        pipe.sync()
        print(json.dumps({"rate_per_s": rate,
                          **summary(run, args.seconds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
