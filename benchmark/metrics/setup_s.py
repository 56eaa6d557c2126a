"""Seconds from the process's start to the first timed request: torch's
import, the kernels' build or load, the seeded sources and the warm pass
over every shape of the cell."""


def read(run):
    return run.setup_s
