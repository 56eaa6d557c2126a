"""Block-sharded encoding over ``torch.distributed``.

The C++ library is single-threaded; its only parallel structure is that
blocks are independent (the edge clamp is inside a block, block_utils.cpp:
7-41). So the block axis is the distribution axis: each rank encodes one
contiguous shard of the blocks on its own device with no communication, and
collectives appear only at the end: an all-gather of the words and errors,
so that every rank holds the whole stream (rank 0 writes the file), and an
all-reduce of the summed error into a global MSE.

Launch one process per GPU with ``torchrun --nproc_per_node=N``, or give
``init_multihost`` the address, world size and rank. NCCL refuses two ranks
on one GPU, so one GPU runs a world of one; the CPU runs any world size on
``gloo``.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..image import DeviceLike, words_to_numpy


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world(group=None):
    if _grouped():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


def rank_device(device: DeviceLike = None) -> torch.device:
    """The device this rank encodes on: ``cuda:LOCAL_RANK`` by default (a
    missing CUDA device raises), or what ``device`` names."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to encode the shard on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def pad_to_multiple(blocks: torch.Tensor, mult: int):
    """Pad the block axis to a multiple of ``mult`` by replicating block 0 (so
    every padded block is a valid block); returns (padded, original_n)."""
    n = blocks.shape[0]
    rem = (-n) % mult
    if rem == 0:
        return blocks, n
    pad = blocks[:1].expand((rem,) + tuple(blocks.shape[1:]))
    return torch.cat([blocks, pad], dim=0), n


def shard_encode(encode_fn: Callable, blocks, group=None,
                 device: DeviceLike = None):
    """Run a batched block encoder sharded over the ranks of ``group``.

    ``encode_fn(blocks) -> (words, err)`` is any of the port's block
    encoders (``kernels/``): on a CUDA shard it launches the kernel, on a
    CPU shard it runs the plain version. This one function stands for both
    of the JAX package's ``shard_encode`` and ``shard_encode_pallas``: the
    port has one route.

    ``blocks`` (an array or a tensor, the same on every rank) is padded to a
    multiple of the world size; this rank encodes its contiguous shard on
    ``rank_device(device)``; the words and errors come back to every rank by
    an all-gather and the summed error by an all-reduce. Returns (words
    (N,W), err (N,), mse) on this rank's device, where ``mse`` is the summed
    error of the N blocks (the padding left out) over N * 16, as a float.
    Outside an initialised process group it is one rank's encode of all the
    blocks, with no collective.
    """
    dev = rank_device(device)
    x = blocks if isinstance(blocks, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(blocks))
    world, rank = _world(group)
    padded, n = pad_to_multiple(x, world)
    per = padded.shape[0] // world
    words, err = encode_fn(padded[rank * per:(rank + 1) * per].to(dev)
                           .contiguous())
    real = min(max(n - rank * per, 0), per)          # blocks of this shard
    total = err[:real].double().sum().reshape(1)     # that are not padding
    if _grouped():                    # a world of one runs them too
        all_words = words.new_empty((world * per,) + tuple(words.shape[1:]))
        all_err = err.new_empty((world * per,))
        dist.all_gather_into_tensor(all_words, words.contiguous(),
                                    group=group)
        dist.all_gather_into_tensor(all_err, err.contiguous(), group=group)
        dist.all_reduce(total, group=group)
        words, err = all_words, all_err
    mse = total.item() / (n * padded.shape[1]) if n else 0.0
    return words[:n], err[:n], mse


def gather_words(words: torch.Tensor) -> np.ndarray:
    """The packed words to the host as little-endian uint32 (the block to
    shard mapping is fixed, so the stream is already in block order)."""
    return words_to_numpy(words)


def gather_words_global(words: torch.Tensor, group=None) -> np.ndarray:
    """Every rank's words, concatenated in rank order, on every rank's host.

    ``words`` is this rank's own shard, of the same length on every rank
    (``shard_encode`` already returns the whole stream; this is for words a
    rank encoded alone). Outside a process group it is ``gather_words``."""
    if not _grouped():
        return gather_words(words)
    world, _ = _world(group)
    w = words.contiguous()
    out = w.new_empty((world * w.shape[0],) + tuple(w.shape[1:]))
    dist.all_gather_into_tensor(out, w, group=group)
    return gather_words(out)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None) -> bool:
    """Initialise the default ``torch.distributed`` process group.

    Reads torchrun's environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) where the arguments are not given;
    ``coordinator_address`` is ``host:port``. The backend is NCCL where CUDA
    is available and gloo otherwise, unless ``backend`` names one. A single
    process with no coordinator is a no-op that returns False; a group
    already initialised returns True.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and env.get("MASTER_ADDR") \
            and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if (num_processes is None or num_processes <= 1) \
            and coordinator_address is None:
        return False
    if coordinator_address is None:
        raise ValueError("init_multihost: a world of several processes needs "
                         "a coordinator address (MASTER_ADDR, MASTER_PORT)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank_device())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes or 1, rank=process_id or 0)
    return True
