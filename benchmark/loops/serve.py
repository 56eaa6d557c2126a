"""The serve loop: an open loop of texture-encode requests at a fixed rate.

Mix keys: ``rate_per_s``; ``sizes`` (square sides) with ``frame``, the
number of requests of each size in every run of ``sum(frame)`` consecutive
requests; ``pool_per_size`` seeded source textures of each size, with alpha
kinds cycled from ``alpha``.

Every seed offers the same work: each frame holds the same sizes and the
same set of gaps between arrivals (the quantiles of an exponential
distribution of mean 1 / rate, so Poisson-like arrivals at the stated rate),
both in an order drawn from the seed. The requests of one size take that
size's pool textures in turn, so each is used alike. A request is due at its
arrival time, is issued when the host gets to it (FIFO on one compute
stream), and is complete when its words are on the host; its latency runs
from its due time. The words of the first ``PSNR_REQUESTS`` requests are
kept for the PSNR (RGB where every alpha kind is opaque, RGBA otherwise); a
request may still come up to ``DRAIN_S`` past the window's close.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from .. import textures
from ..pipe import clock
from ..record import (Call, Item, Sample, make_level, psnr_channels, rng,
                      sample_index)

RING_FRAMES = 4         # word buffers per size: 4 frames' worth, at least 8
PSNR_REQUESTS = 200
DRAIN_S = 60.0


def schedule(mix: dict, seed: int, seconds: float):
    """[(due seconds, size index, pool index)] of the requests due in
    [0, seconds)."""
    frame = [int(c) for c in mix["frame"]]
    m = sum(frame)
    rate = float(mix["rate_per_s"])
    q = (np.arange(m) + 0.5) / m
    gaps = -np.log1p(-q)
    gaps = gaps / gaps.sum() * m / rate           # a frame lasts m / rate
    kinds = np.repeat(np.arange(len(frame)), frame)
    per = int(mix["pool_per_size"])
    taken = [0] * len(frame)
    r = rng(seed, 3)
    out, t = [], 0.0
    while True:
        for g, k in zip(r.permutation(gaps), r.permutation(kinds)):
            t += g
            if t >= seconds:
                return out
            out.append((t, int(k), taken[k] % per))
            taken[k] += 1


class Serve:
    def __init__(self, mix: dict, seed: int, pipe, enc, opts,
                 seconds: float):
        self.mix, self.seed, self.pipe = mix, seed, pipe
        self.sched = schedule(mix, seed, seconds)
        dev = pipe.device
        g = textures.generator(seed, dev)
        sizes = [int(s) for s in mix["sizes"]]
        per = int(mix["pool_per_size"])
        alphas = mix["alpha"]
        src = pipe.host((sum(4 * s * s for s in sizes) * per,), torch.uint8)
        self.pool, so = [], 0
        for s in sizes:
            row = []
            for j in range(per):
                u8 = textures.to_u8(textures.texture(
                    g, s, alphas[j % len(alphas)], dev))
                row.append(make_level(u8, src[so:so + u8.numel()].view(
                    u8.shape), enc, opts))
                so += u8.numel()
            self.pool.append(row)
        words = [4 * ((s + 3) // 4) ** 2 for s in sizes]
        self.first = PSNR_REQUESTS
        ring = [max(8, RING_FRAMES * int(c)) for c in mix["frame"]]
        firsts = [sum(1 for _, k, _ in self.sched[:self.first] if k == i)
                  for i in range(len(sizes))]
        arena = pipe.host((sum(w * (r + f) for w, r, f in
                               zip(words, ring, firsts)),), torch.int32)
        self.rings, self.keep, off = [], [], 0
        for w, r, f in zip(words, ring, firsts):
            self.rings.append([arena[off + i * w:off + (i + 1) * w]
                               for i in range(r)])
            off += r * w
            self.keep.append([arena[off + i * w:off + (i + 1) * w]
                              for i in range(f)])
            off += f * w

    def levels(self):
        return [lv for row in self.pool for lv in row]

    def warm(self, encode) -> None:
        """One request of each size, then two of each back to back."""
        for reps in (1, 2):
            jobs = [self.pipe.submit(row[0].host, self.rings[k][i], encode)
                    for k, row in enumerate(self.pool) for i in range(reps)]
            self.pipe.sync()
            for job in jobs:
                self.pipe.wait(job)

    def window(self, encode, seconds: float, run) -> None:
        pipe = self.pipe
        inflight = deque()
        busy = [dict() for _ in self.rings]       # ring slot -> in flight
        used = [0] * len(self.rings)
        kept = [0] * len(self.rings)
        t0 = clock()

        def complete(rec, now):
            item, job, lv, buf, idx, k, slot = rec
            busy[k].pop(slot, None)
            if job.failed:
                run.notes.append(job.note)
                return
            item.done = now
            run.samples.append(Sample(
                lv, idx, buf.view(-1, 4)[torch.from_numpy(idx)].numpy()))

        def poll():
            while inflight and pipe.done(inflight[0][1]):
                complete(inflight.popleft(), clock() - t0)

        with pipe.span("bench.window"):
            for no, (due, k, j) in enumerate(self.sched):
                with pipe.span("bench.idle"):
                    while True:
                        poll()
                        left = due - (clock() - t0)
                        if left <= 0:
                            break
                        time.sleep(min(left, 5e-4) if left > 2e-3 else 0)
                lv = self.pool[k][j]
                if no < self.first:
                    buf, slot = self.keep[k][kept[k]], None
                    kept[k] += 1
                else:
                    slot = used[k] % len(self.rings[k])
                    used[k] += 1
                    while slot in busy[k]:          # ring full: wait for it
                        pipe.wait(busy[k][slot])
                        poll()
                    buf = self.rings[k][slot]
                issued = clock() - t0
                item = Item(lv.texels, due, issued)
                run.items.append(item)
                idx = sample_index(self.seed, no, lv.blocks)
                job = pipe.submit(lv.host, buf, encode)
                run.calls.append(Call(lv.texels, job.t_call[1] - job.t_call[0],
                                      lv.bounds, job.failed))
                if slot is not None:
                    busy[k][slot] = job
                if no < self.first:
                    run.psnr_pairs.append((lv, buf))
                inflight.append((item, job, lv, buf, idx, k, slot))
            with pipe.span("bench.drain"):
                while inflight and clock() - t0 < seconds + DRAIN_S:
                    poll()
                    time.sleep(1e-4)
        done = [it.done for it in run.items if it.done is not None]
        run.window_s = max([seconds] + done)
        run.psnr_channels = psnr_channels(self.mix["alpha"])


def make(mix, seed, pipe, enc, opts, seconds):
    return Serve(mix, seed, pipe, enc, opts, seconds)
