"""Upload, encode and download of one texture level, on three streams.

Each source is uploaded on the harness's upload stream, encoded by the
program on the compute stream (the device's current stream, where the port
launches its kernels) once the upload's event has fired, and its words are
downloaded into pinned host memory on the download stream once the compute
stream's event has fired. Uploads and downloads use streams of their own so
that the next level's upload never queues behind a download that waits for
the encoder (the card has a copy engine each way). A level is complete when
its download's event has fired: its words are then on the host.

On the CPU (the harness's tests) the same calls run one after another and a
level is complete when ``submit`` returns.
"""
from __future__ import annotations

import contextlib
import time
import traceback
from dataclasses import dataclass

import torch

clock = time.perf_counter


@dataclass
class Job:
    """One level in flight: its download's event, the tensors the streams
    still use, and the host's span around the program's call."""
    event: object
    keep: tuple
    t_call: tuple            # (start, end) of from_array + compress, host
    failed: bool = False
    note: str = ""


class Pipe:
    def __init__(self, device, trace: bool = False):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.trace = trace
        self.spans = []          # (name, start, end) host clock, traced
        if self.cuda:
            self.compute = torch.cuda.current_stream(self.device)
            self.up = torch.cuda.Stream(self.device)
            self.down = torch.cuda.Stream(self.device)

    def span(self, name: str):
        """A host span, kept in ``spans`` for the trace (traced runs
        only)."""
        if self.trace:
            return self._record(name)
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def _record(self, name: str):
        t0 = clock()
        try:
            yield
        finally:
            self.spans.append((name, t0, clock()))

    def host(self, shape, dtype) -> torch.Tensor:
        """A host buffer the copies can run from or into asynchronously."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def submit(self, src: torch.Tensor, dst: torch.Tensor, encode) -> Job:
        """Upload ``src`` (H, W, 4) uint8, call ``encode(device_uint8)``
        (which returns a ``CompressedImage``) and download its words into
        ``dst`` (int32, as many words as the level has). Never waits for the
        device. An exception or a malformed result marks the job failed."""
        with self.span("bench.upload"):
            if self.cuda:
                with torch.cuda.stream(self.up):
                    dev = torch.empty(src.shape, dtype=torch.uint8,
                                      device=self.device)
                    dev.copy_(src, non_blocking=True)
                    ev_up = torch.cuda.Event()
                    ev_up.record(self.up)
                self.compute.wait_event(ev_up)
                dev.record_stream(self.compute)
            else:
                dev = src.clone()
        t0 = clock()
        try:
            with self.span("bench.compress"):
                out = encode(dev)
            words = out.blocks
            if words.dtype != torch.int32 or words.numel() != dst.numel():
                raise ValueError(f"the call returned {tuple(words.shape)} "
                                 f"{words.dtype} words for {dst.numel()}")
        except Exception:                     # a failed call, not a crash
            return Job(None, (dev,), (t0, clock()), True,
                       traceback.format_exc(limit=3))
        t1 = clock()
        with self.span("bench.download"):
            if self.cuda:
                ev_c = torch.cuda.Event()
                ev_c.record(self.compute)
                with torch.cuda.stream(self.down):
                    self.down.wait_event(ev_c)
                    dst.copy_(words.reshape(dst.shape), non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(self.down)
                words.record_stream(self.down)
            else:
                dst.copy_(words.reshape(dst.shape))
                ev = None
        return Job(ev, (dev, words), (t0, t1))

    @staticmethod
    def done(job: Job) -> bool:
        return job.event is None or job.event.query()

    def wait(self, job: Job) -> None:
        if job.event is not None:
            with self.span("bench.wait"):
                job.event.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
