"""Frozen copy of the port's ``kernels/bc4.py`` (dtypes and the 16-pixel row
helpers), kept with the benchmark so that a later change to the program
cannot move the yardstick. Imports nothing of the program.
"""
from __future__ import annotations

import torch

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64


def _sum16(x: torch.Tensor) -> torch.Tensor:
    """(16, N) -> (1, N): x[0] + x[1] + ... + x[15], added left to right."""
    acc = x[0:1]
    for p in range(1, 16):
        acc = acc + x[p:p + 1]
    return acc


def _min16(x):
    return torch.amin(x, dim=0, keepdim=True)


def _max16(x):
    return torch.amax(x, dim=0, keepdim=True)
