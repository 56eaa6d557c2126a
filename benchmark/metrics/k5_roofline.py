"""K5, the full BC7 search (``bc7_full_kernel``, ``csrc/bc7_full_m*``):
the least time of its launches in the window, from the frozen counts at the
configuration's budget on this run's blocks, over their device time in the
trace, in %."""
KERNEL, NAME = "k5", "bc7_full_kernel"


def read(run):
    return run.roofline(KERNEL, NAME)
