"""Kernel launches of the program in the window (its own counters,
``kernels.launch_counts``), per request completed."""


def read(run):
    done = sum(1 for it in run.items if not it.failed)
    if run.launches is None or not done:
        return None
    return run.launches / done
