"""Time limits, order and run modes for the suite under `tests/`.

`tests/conftest.py` sets up JAX for the suite and must import it first, so
this file imports JAX only inside the hook that needs it. Tests outside
`tests/` (the benchmark's own) are left as they are.
"""
import faulthandler
import os
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent / "tests"

# Every test's setup, call and teardown must end within this many seconds,
# about twice the slowest test the suite keeps. On an overrun faulthandler's
# watchdog, a C thread that fires even inside an XLA compile holding the GIL,
# writes every thread's stack to the worker's stderr and ends the process.
# xdist then fails the test by name ("worker 'gwN' crashed while running
# ...") and a fresh worker takes over the rest of its chunk, instead of the
# hung test eating the run's clock.
DEFAULT_LIMIT_S = 480

# The JAX package's XLA-path tests run op by op: each jitted encoder unrolls
# its whole search into one graph, and XLA-CPU's compile of it (per static
# configuration and block count) costs minutes and tens of GB, far more
# than running the same operations on the same data.
EAGER = {
    "tests/test_bc1.py::test_refinement_monotonic_quality",
    "tests/test_bc7_full.py::test_error_model_matches_decoder",
    "tests/test_bc7_full.py::test_error_model_matches_decoder_with_alpha",
    "tests/test_bc7_full.py::test_full_beats_or_matches_fast",
    "tests/test_bc7_full.py::test_mode_mask_restricts",
    "tests/test_bc7_full.py::test_quality_budget_monotonic",
    "tests/test_bc7_full.py::test_gradient_high_quality",
    "tests/test_native_oracle.py::test_bc7_full_emitted_blocks_agree",
    "tests/test_options.py::test_colour_restrict_bars_mode6",
    "tests/test_options.py::test_alpha_restrict_bars_combined_on_punch_through",
    "tests/test_options.py::test_performance_scales_search_effort",
    "tests/test_options.py::test_b3d_refinement_joint_cube_changes_output",
}

# Over the limit even eagerly, in their Pallas interpret compiles; each
# property is held in the default run by tests/test_slow_counterparts.py.
SLOW = {
    "tests/test_options.py::test_bc6h_options_quality_reaches_encoder",
    "tests/test_quality_gate.py::test_quality_gate_cheap_rows_pallas",
}

_STACK_FILE = pytest.StashKey()


def pytest_configure(config):
    # A duplicate of stderr taken while pytest's capture is suspended, so the
    # watchdog's stack is not swallowed by the capture of the test it ends.
    config.stash[_STACK_FILE] = os.fdopen(os.dup(2), "w")


def pytest_unconfigure(config):
    config.stash[_STACK_FILE].close()


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    """Mark EAGER and SLOW, and run the port's test modules first.

    Under xdist's `--dist load` each worker is first dealt a run of
    consecutive tests, a 24th of them with six workers, and the rest goes
    out a few at a time to workers that drain. Sorted by name, the JAX
    package's compile-bound modules came first and filled half of those
    first runs, which then took twice as long as the others; after the
    port's modules they go to whichever worker is free."""
    for it in items:
        if it.nodeid in EAGER:
            it.add_marker(pytest.mark.eager)
        if it.nodeid in SLOW:
            it.add_marker(pytest.mark.slow)
    items.sort(key=lambda it: not it.path.name.startswith("test_torch_"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if TESTS not in item.path.parents:
        return (yield)
    faulthandler.dump_traceback_later(
        DEFAULT_LIMIT_S, exit=True, file=item.config.stash[_STACK_FILE])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    """Run an `eager` test's body under jax.disable_jit()."""
    if item.get_closest_marker("eager") is None:
        return (yield)
    import jax
    with jax.disable_jit():
        return (yield)
