"""The bake loop: a closed loop over a seeded set of textures with full mip
chains, one ``compress`` call per level, cycling over the set.

Mix keys: ``textures`` (a list of ``{"size", "count", "alpha"}``),
``in_flight`` (textures issued and not yet on the host: before uploading
texture i + in_flight the host waits for texture i's words). The set is made in the mix's
order and cycled in an order drawn from the seed; so every seed bakes the
same sizes. The first pass over the set keeps its words for the PSNR (RGB
where every texture is opaque, RGBA otherwise).

The window starts with the first upload and ends when the last texture
issued before ``seconds`` had passed is on the host: every texel counted was
encoded inside it.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import torch

from .. import textures
from ..pipe import clock
from ..record import (Call, Item, Sample, make_level, psnr_channels, rng,
                      sample_index)


@dataclass
class Texture:
    size: int
    alpha: str
    levels: list
    first: list          # word buffers of the first pass (kept)
    later: list          # word buffers of every later pass (reused)

    @property
    def texels(self) -> int:
        return sum(lv.texels for lv in self.levels)


class Bake:
    def __init__(self, mix: dict, seed: int, pipe, enc, opts):
        self.mix, self.seed, self.pipe = mix, seed, pipe
        self.in_flight = int(mix["in_flight"])
        dev = pipe.device
        g = textures.generator(seed, dev)
        specs = [(e["size"], e["alpha"]) for e in mix["textures"]
                 for _ in range(int(e["count"]))]
        src_bytes = sum(4 * s * s for size, _ in specs
                        for s in textures.chain_sizes(size))
        blocks = sum(((s + 3) // 4) ** 2 for size, _ in specs
                     for s in textures.chain_sizes(size))
        # one host arena for the sources and one for the words
        src = pipe.host((src_bytes,), torch.uint8)
        words = pipe.host((2 * 4 * blocks,), torch.int32)
        so = wo = 0
        self.textures = []
        for size, alpha in specs:
            levels, first, later = [], [], []
            for u8 in textures.mip_chain(textures.texture(g, size, alpha,
                                                          dev)):
                n = u8.numel()
                levels.append(make_level(u8, src[so:so + n].view(u8.shape),
                                         enc, opts))
                so += n
                nw = 4 * levels[-1].blocks
                first.append(words[wo:wo + nw])
                later.append(words[wo + nw:wo + 2 * nw])
                wo += 2 * nw
            self.textures.append(Texture(size, alpha, levels, first, later))
        self.order = rng(seed, 2).permutation(len(self.textures)).tolist()

    def levels(self):
        return [lv for t in self.textures for lv in t.levels]

    def warm(self, encode) -> None:
        """One chain of each size in the set, with as many in flight as the
        window has."""
        seen, todo = set(), []
        for t in self.textures:
            if t.size not in seen:
                seen.add(t.size)
                todo.append(t)
        pending = deque()
        for t in todo:
            if len(pending) >= self.in_flight:
                for job in pending.popleft():
                    self.pipe.wait(job)
            pending.append([self.pipe.submit(lv.host, buf, encode)
                            for lv, buf in zip(t.levels, t.later)])
        self.pipe.sync()

    def window(self, encode, seconds: float, run) -> None:
        pipe = self.pipe
        n = len(self.textures)
        inflight = deque()
        call_no = 0
        t0 = clock()

        def finish():
            tex, issued, jobs = inflight.popleft()
            for _, _, job, _ in jobs:
                pipe.wait(job)
            done = clock() - t0
            failed = False
            for lv, buf, job, idx in jobs:
                run.calls.append(Call(lv.texels, job.t_call[1] - job.t_call[0],
                                      lv.bounds, job.failed))
                if job.failed:
                    failed = True
                    run.notes.append(job.note)
                    continue
                run.samples.append(Sample(
                    lv, idx, buf.view(-1, 4)[torch.from_numpy(idx)].numpy()))
            run.items.append(Item(tex.texels, issued, issued,
                                  None if failed else done))
            return done

        i = 0
        end = 0.0
        with pipe.span("bench.window"):
            while True:
                if len(inflight) >= self.in_flight:
                    end = finish()
                if clock() - t0 >= seconds:
                    break
                tex = self.textures[self.order[i % n]]
                bufs = tex.first if i < n else tex.later
                issued = clock() - t0
                jobs = []
                for lv, buf in zip(tex.levels, bufs):
                    idx = sample_index(self.seed, call_no, lv.blocks)
                    jobs.append((lv, buf, pipe.submit(lv.host, buf, encode),
                                 idx))
                    call_no += 1
                inflight.append((tex, issued, jobs))
                if i < n:
                    run.psnr_pairs.extend(zip(tex.levels, tex.first))
                i += 1
            while inflight:
                end = finish()
        run.window_s = end
        run.psnr_channels = psnr_channels(
            e["alpha"] for e in self.mix["textures"])


def make(mix, seed, pipe, enc, opts, seconds):
    return Bake(mix, seed, pipe, enc, opts)
