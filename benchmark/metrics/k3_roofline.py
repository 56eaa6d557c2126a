"""K3, the partition shortlist (``bc7_est_kernel``,
``csrc/bc7_est_kernel.cu``): the least time of its launches in the window
over their device time in the trace, in %."""
KERNEL, NAME = "k3", "bc7_est_kernel"


def read(run):
    return run.roofline(KERNEL, NAME)
