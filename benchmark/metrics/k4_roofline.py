"""K4, the fast BC7 search (``bc7_fast_kernel``,
``csrc/bc7_fast_kernel.cu``): the least time of its launches in the window
over their device time in the trace, in %."""
KERNEL, NAME = "k4", "bc7_fast_kernel"


def read(run):
    return run.roofline(KERNEL, NAME)
