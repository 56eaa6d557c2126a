"""The device trace of a traced run (``--trace 1``).

``torch.profiler`` records the window with CUDA activity alone: no torch
operator is recorded on the host, so the host pays the profiler only
CUPTI's record of each runtime call, and the host-clock metrics of a traced
run stay near an untraced run's. The profiler starts before the warm pass,
so that the first launch of each kernel under it falls in set-up. The
window is marked on the card: a short ``torch.cuda._sleep`` kernel
(``spin_kernel``) goes on the compute stream as the window opens, and
another once it has closed; the traced window runs from the start of the
first to the start of the second. A long ``spin_kernel`` (the guard)
follows the close's marker, and the profiler runs on for ``EDGE_S`` seconds
after its start and after the guard with the card idle: kineto drops the
device records that its clock puts outside the profiler's own start and
stop, and that clock can lie some tenths of a second or more off the host's
(torch 2.11 on an H100 warned of 0.97 s), so that a marker at the trace's
very end can be lost. The harness's host spans (``bench.*``, from
``pipe.Pipe.span``) are taken on the host clock and put on the trace's clock
by the first marker (its start on the card less its launch on the host).
The trace is written to a file under ``TMPDIR``, read, and deleted.

A trace without its guard, or with fewer than two short markers before it,
is refused (``parse``); ``TraceData.missing`` finds a window whose program
kernels the trace holds another number of than the program launched.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass

import torch

from .pipe import clock

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
MARKER = "spin_kernel"       # torch.cuda._sleep's kernel
MARK_CYCLES = 1000           # a window's marker: about a microsecond
GUARD_CYCLES = 20_000_000    # the guard: about 10 ms
GUARD_MIN_US = 1000.0        # a marker at least this long is the guard
EDGE_S = 5.0                 # the profiler's idle seconds at each end


@dataclass
class TraceData:
    window: tuple              # (start, end) of the traced window, us
    device: list               # (name, start us, duration us) in the window
    host: list                 # (name, start us, duration us) bench.* spans
    calls: list = ()           # (name, start us, duration us) CUDA API calls

    def first(self) -> tuple:
        """(name, seconds from the window's start) of the first operation on
        the card, and of the first host span, in the window."""
        dev = min(self.device, key=lambda d: d[1], default=("-", 0.0, 0.0))
        host = min(self.host, key=lambda h: h[1], default=("-", 0.0, 0.0))
        return ((dev[0][:60], (dev[1] - self.window[0]) / 1e6),
                (host[0], (host[1] - self.window[0]) / 1e6))

    def longest_calls(self, top: int = 5) -> list:
        """[(name, seconds from the window's start, seconds)] of the CUDA
        API calls in the window that took the host longest."""
        return [(n, (s - self.window[0]) / 1e6, d / 1e6) for n, s, d in
                sorted(self.calls, key=lambda c: -c[2])[:top]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def _merged(self):
        iv = sorted((max(s, self.window[0]), min(s + d, self.window[1]))
                    for _, s, d in self.device)
        out = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation of the process ran
        on the card."""
        return sum(b - a for a, b in self._merged()) / 1e6

    def kernel_seconds(self, name_part: str) -> float:
        return sum(d for n, _, d in self.device if name_part in n) / 1e6

    def missing(self, launches: dict) -> list:
        """[(kernel, records in the trace, launches)] of the program's
        kernels that the window's trace holds another number of than the
        program counted launches of (``launches``: the program's count per
        kernel, whose ``__global__`` name is ``<kernel>_kernel``)."""
        out = []
        for kernel, n in sorted(launches.items()):
            if n:
                part = f"{kernel}_kernel"
                got = sum(1 for name, _, _ in self.device if part in name)
                if got != n:
                    out.append((kernel, got, n))
        return out

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the operations that took most device time."""
        tot = {}
        for n, _, d in self.device:
            key = n.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0].strip()[:120]
            tot[key] = tot.get(key, 0.0) + d / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:top]]

    def gaps(self, top: int = 10) -> list:
        """[(what the host was doing, seconds from the window's start,
        seconds)] of the longest gaps in which nothing of the process ran on
        the card, named by the innermost harness span open when the gap
        began."""
        busy = self._merged()
        edges = [self.window[0]] + [x for ab in busy for x in ab] + [
            self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host, key=lambda h: h[1])
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            name, best = "bench.window", None
            for n, s, d in host:
                if s > a:
                    break
                if s + d >= a and n != "bench.window" and (
                        best is None or s >= best):
                    name, best = n, s
            out.append((name, (a - self.window[0]) / 1e6, (b - a) / 1e6))
        return out

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host was doing, seconds]] of the longest gaps."""
        return [[n, s] for n, _, s in self.gaps(top)]


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.t_open = None
        self.launch_s = None

    def start(self) -> None:
        """Starts the profiler; call it before the warm pass."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        torch.cuda._sleep(MARK_CYCLES)       # loads the marker's kernel
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        time.sleep(EDGE_S)
        # its first launch under the profiler, before the window's two
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()

    def open(self) -> None:
        """Marks the window's opening on the card; call it last before the
        window, with the card idle."""
        if self.prof is None:
            return
        self.t_open = clock()
        torch.cuda._sleep(MARK_CYCLES)
        self.launch_s = clock() - self.t_open

    def stop(self, spans=()):
        """Marks the window's close, stops the profiler and returns the
        window's ``TraceData`` with the host ``spans`` ((name, start s, end
        s) on the host clock); None when not tracing."""
        if self.prof is None:
            return None
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda._sleep(GUARD_CYCLES)
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
        self.prof.stop()
        fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return parse(events, spans, self.t_open)


def parse(events, spans, t_open: float) -> TraceData:
    """The window between the last two short markers before the last guard
    (the window's opening and close), the device's operations in it, and the host
    ``spans`` moved onto the trace's clock."""
    dev, marks, calls = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        op = (e.get("name", "?"), float(e["ts"]), float(e["dur"]))
        if e.get("cat") in RUNTIME_CATS:
            calls.append(op)
        elif e.get("cat") in DEVICE_CATS:
            (marks if MARKER in op[0] else dev).append(op)
    marks.sort(key=lambda m: m[1])
    guard = next((m for m in reversed(marks) if m[2] >= GUARD_MIN_US), None)
    if guard is None:
        raise RuntimeError(f"devtrace: no guard {MARKER} in the trace: the "
                           "profiler stopped recording early")
    short = [m for m in marks if m[1] < guard[1] and m[2] < GUARD_MIN_US]
    if len(short) < 2:
        raise RuntimeError(f"devtrace: {len(short)} of the window's two "
                           f"{MARKER} markers in the trace")
    w0, w1 = short[-2][1], short[-1][1]
    off = w0 - t_open * 1e6
    host = [(n, a * 1e6 + off, (b - a) * 1e6) for n, a, b in spans]
    inside = lambda op: op[1] + op[2] > w0 and op[1] < w1
    return TraceData((w0, w1), [d for d in dev if inside(d)], host,
                     [c for c in calls if inside(c)])
