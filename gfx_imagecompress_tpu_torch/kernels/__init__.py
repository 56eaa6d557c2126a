"""Block encoders: hand-written CUDA kernels with their plain PyTorch
versions beside them.

Each wrapper adds one to its kernel's count where it launches the kernel and
nowhere else; ``launch_counts`` reads the counts and ``reset_launch_counts``
zeroes them, so a run can show that it went through the kernels. The
shortlist's launches are also counted by configuration
(``bc7_est.LAUNCHES_BY_CONFIG``), which the reset empties.
"""
from . import bc1, bc4, bc6h, bc7_est, bc7_fast, bc7_full

_TABLES = (bc1.LAUNCHES, bc4.LAUNCHES, bc7_est.LAUNCHES, bc7_fast.LAUNCHES,
           bc7_full.LAUNCHES, bc6h.LAUNCHES)


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset."""
    return {name: n for table in _TABLES for name, n in table.items()}


def reset_launch_counts() -> None:
    for table in _TABLES:
        for name in table:
            table[name] = 0
    bc7_est.LAUNCHES_BY_CONFIG.clear()
