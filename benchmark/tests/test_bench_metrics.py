"""The metric arithmetic on synthetic timings: a stall in the window moves
mtexel_per_s and p95_ms the way a user would feel it."""
import pytest

from benchmark import devtrace, spec
from benchmark.devtrace import TraceData
from benchmark.record import Call, Item, Run


def read(name, run):
    return spec.reader(name).read(run)


def bake_run(stall_s=0.0):
    """40 textures of 10 Mtexel, one every 0.1 s, a stall after the 20th."""
    run = Run("cell", 1, 4.0)
    t = 0.0
    for i in range(40):
        t += 0.1 + (stall_s if i == 20 else 0.0)
        run.items.append(Item(10_000_000, t - 0.1, t - 0.1, t))
    run.window_s = t
    return run


def serve_run(stall_s=0.0):
    """A request every 10 ms, served in 5 ms, and a stall at 1 s that every
    request due during it waits out."""
    run = Run("cell", 1, 2.0)
    free = 0.0
    for i in range(200):
        due = i * 0.01
        start = max(due, free)
        if stall_s and due <= 1.0 < start + 0.005:
            start = max(start, 1.0 + stall_s)
        free = start + 0.005
        run.items.append(Item(1, due, due, free))
    run.window_s = 2.0
    return run


def test_mtexel_per_s_falls_with_a_stall():
    base, stalled = read("mtexel_per_s", bake_run()), read(
        "mtexel_per_s", bake_run(1.0))
    assert base == pytest.approx(100.0)
    assert stalled == pytest.approx(400.0 / 5.0)


def test_p95_ms_rises_with_a_stall_and_counts_requests_that_never_came():
    assert read("p95_ms", serve_run()) == pytest.approx(5.0)
    assert read("p95_ms", serve_run(0.5)) > 100.0
    run = serve_run()
    for it in run.items[-20:]:
        it.done = None
    assert read("p95_ms", run) >= 1e9


def test_lag_and_host_ms_and_launches():
    run = serve_run()
    for i, it in enumerate(run.items):
        it.issued = it.due + (0.002 if i % 10 == 0 else 0.0)
    assert read("lag_p95_ms.serve", run) == pytest.approx(2.0)
    run.calls = [Call(1, 0.001, {}), Call(1, 0.003, {}),
                 Call(1, 9.0, {}, failed=True)]
    assert read("host_ms_per_call.serve", run) == pytest.approx(2.0)
    run.launches = 400
    assert read("launches_per_request.serve", run) == pytest.approx(2.0)
    assert read("launches_per_texture.bake", run) == pytest.approx(2.0)


def test_idle_share_and_roofline_from_a_trace():
    run = bake_run()
    run.calls = [Call(16, 0.0, {"k5": 0.25, "k3": 0.01})] * 2
    # window 10 s; kernels busy 2 + 3 s, overlapping by 1 s; a copy 1 s
    run.trace = TraceData((0.0, 10e6), [
        ("void bc7_full_kernel<1, 8>(float const*)", 1e6, 2e6),
        ("void bc7_full_kernel<2, 8>(float const*)", 2e6, 2e6),
        ("Memcpy HtoD (Pinned -> Device)", 6e6, 1e6)],
        [("bench.wait", 3.9e6, 1e6)])
    assert run.trace.busy_s == pytest.approx(4.0)
    assert read("idle_share.bake", run) == pytest.approx(60.0)
    assert read("k5_roofline.bake", run) == pytest.approx(100 * 0.5 / 4.0)
    assert read("k3_roofline.bake", run) is None        # no K3 in the trace
    gaps = dict((n, s) for n, s in run.trace.idle_gaps())
    assert gaps["bench.wait"] == pytest.approx(2.0)
    assert run.trace.device_ops()[0][0].startswith("bc7_full_kernel<")


def test_the_trace_window_runs_between_the_markers():
    """The window runs between the last two spin_kernel markers' starts;
    what lies outside it (the profiler's start) is not counted; host spans
    are moved onto the trace's clock by the window's first marker."""
    ev = lambda name, ts, dur, cat="kernel": {
        "ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [ev("at::cuda::(anonymous namespace)::spin_kernel(long)",
                 50.0, 1.0),                                  # before
              ev("void fill_kernel()", 100.0, 5.0),
              ev("at::cuda::(anonymous namespace)::spin_kernel(long)",
                 1000.0, 1.0),
              ev("Memcpy HtoD (Pinned -> Device)", 1010.0, 90.0, "gpu_memcpy"),
              ev("void bc7_fast_kernel<2, true>()", 1100.0, 400.0),
              ev("cudaLaunchKernel", 1090.0, 3.0, "cuda_runtime"),
              ev("cudaMalloc", 1200.0, 50.0, "cuda_runtime"),
              ev("at::cuda::(anonymous namespace)::spin_kernel(long)",
                 2000.0, 1.0),
              ev("at::cuda::(anonymous namespace)::spin_kernel(long)",
                 250000.0, 10000.0)]                          # the guard
    # the host opened the window at 5.0 s; it waited from 5.0005 s on
    t = devtrace.parse(events, [("bench.wait", 5.0005, 5.0009)], 5.0)
    assert t.window == (1000.0, 2000.0)
    assert t.busy_s == pytest.approx(490e-6)
    assert [n for n, _, _ in t.device] == ["Memcpy HtoD (Pinned -> Device)",
                                           "void bc7_fast_kernel<2, true>()"]
    name, start, secs = t.gaps()[0]
    assert (name, start, secs) == ("bench.wait", pytest.approx(500e-6),
                                   pytest.approx(500e-6))
    assert t.first() == (("Memcpy HtoD (Pinned -> Device)",
                          pytest.approx(10e-6)),
                         ("bench.wait", pytest.approx(500e-6)))
    assert t.longest_calls(1) == [("cudaMalloc", pytest.approx(200e-6),
                                   pytest.approx(50e-6))]
    with pytest.raises(RuntimeError):
        devtrace.parse(events[1:3] + events[-1:], [], 5.0)
    # without the profiler's first marker the window is the same
    assert devtrace.parse(events[1:], [], 5.0).window == (1000.0, 2000.0)


def test_a_trace_that_stopped_early_is_refused():
    """Where the profiler dropped the records at the trace's end, the guard
    is lost: the trace is refused, not read between the profiler's start and
    the window's opening. A trace holding another number of a kernel's
    records than the program launched names that kernel."""
    ev = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name,
                                "ts": ts, "dur": dur}
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [ev(spin, 50.0, 1.0),
              ev("void bc7::bc7_full_kernel<0, 0>()", 100.0, 5.0),  # warm
              ev(spin, 1000.0, 1.0),
              ev("void bc7::bc7_full_kernel<0, 0>()", 1100.0, 400.0),
              ev("void bc7_est_kernel<3, 9, 2>()", 1500.0, 40.0)]
    with pytest.raises(RuntimeError, match="stopped recording early"):
        devtrace.parse(events, [], 5.0)
    with pytest.raises(RuntimeError, match="stopped recording early"):
        devtrace.parse(events + [ev(spin, 2000.0, 1.0)], [], 5.0)
    t = devtrace.parse(events + [ev(spin, 2000.0, 1.0),
                                 ev(spin, 250000.0, 10000.0)], [], 5.0)
    assert t.window == (1000.0, 2000.0)
    assert t.missing({"bc7_full": 1, "bc7_est": 1, "bc1": 0}) == []
    assert t.missing({"bc7_full": 3, "bc7_est": 1}) == [("bc7_full", 1, 3)]

