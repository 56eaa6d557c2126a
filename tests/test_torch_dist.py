"""Block-sharded encoding on ``torch.distributed`` (``dist/sharded.py``).

A world of two ``gloo`` processes on the CPU, started by this file (run as a
script it is one rank), encodes BC1 and BC4 blocks sharded, an odd count
among them; every rank must hold the unsharded call's words and errors on
every block and the same MSE. Rank 0 joins through torchrun's environment,
rank 1 through explicit arguments. One GPU runs a world of one on NCCL
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import os
import socket
import subprocess
import sys
import tempfile
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _blocks(case):
    """(encoder name, blocks) of a case; the same on every rank."""
    rng = np.random.default_rng(len(case))
    if case == "bc1_64":
        base = rng.random((64, 1, 4), np.float32)
        return "bc1", np.clip(base + rng.normal(0, 0.08, (64, 16, 4)), 0, 1
                              ).astype(np.float32)
    if case == "bc1_45":
        return "bc1", rng.random((45, 16, 4), np.float32)
    if case == "bc4_45":
        return "bc4", rng.random((45, 16), np.float32)
    if case == "bc4_64":
        return "bc4", rng.random((64, 16), np.float32)
    raise ValueError(case)


CASES = ("bc1_64", "bc1_45", "bc4_45", "bc4_64")


def _encoder(name):
    from gfx_imagecompress_tpu_torch.kernels import bc1, bc4
    return {"bc1": bc1.encode_bc1_blocks, "bc4": bc4.encode_bc4_blocks}[name]


def _worker(rank: int, port: int, out: str) -> None:
    import torch.distributed as dist
    from gfx_imagecompress_tpu_torch.dist import sharded

    if rank == 0:
        os.environ.update(WORLD_SIZE="2", RANK="0", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        ok = sharded.init_multihost(backend="gloo")
    else:
        ok = sharded.init_multihost(coordinator_address=f"127.0.0.1:{port}",
                                    num_processes=2, process_id=rank,
                                    backend="gloo")
    assert ok and dist.get_world_size() == 2 and dist.get_rank() == rank
    res = {}
    for case in CASES:
        name, blocks = _blocks(case)
        words, err, mse = sharded.shard_encode(_encoder(name), blocks,
                                               device="cpu")
        res[f"{case}_words"] = sharded.gather_words(words)
        res[f"{case}_err"] = err.numpy()
        res[f"{case}_mse"] = np.float64(mse)
    # a rank's own shard, gathered to every rank in rank order
    own = torch.full((3, 2), rank, dtype=torch.int32)
    res["global"] = sharded.gather_words_global(own)
    dist.destroy_process_group()
    np.savez(out, **res)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@lru_cache(maxsize=None)
def _world():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    with tempfile.TemporaryDirectory() as td:
        outs = [os.path.join(td, f"r{i}.npz") for i in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, __file__, str(i), str(port), outs[i]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
            for i in range(2)]
        logs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            logs.append(out.decode(errors="replace"))
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-3000:]
        return [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("case", CASES)
def test_two_gloo_ranks_equal_the_unsharded_encode(case):
    name, blocks = _blocks(case)
    want_w, want_e = _encoder(name)(torch.from_numpy(blocks))
    want_w = want_w.numpy().view(np.uint32)
    for res in _world():
        np.testing.assert_array_equal(res[f"{case}_words"], want_w)
        np.testing.assert_array_equal(res[f"{case}_err"], want_e.numpy())
        expect = want_e.double().sum().item() / (blocks.shape[0] * 16)
        np.testing.assert_allclose(float(res[f"{case}_mse"]), expect,
                                   rtol=1e-12)


def test_gather_words_global_concatenates_in_rank_order():
    for res in _world():
        np.testing.assert_array_equal(
            res["global"], np.repeat(np.arange(2, dtype=np.uint32), 3)
            [:, None].repeat(2, 1))


def test_init_multihost_single_process_is_a_no_op(monkeypatch):
    import torch.distributed as dist
    from gfx_imagecompress_tpu_torch.dist.sharded import init_multihost
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert init_multihost() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert init_multihost() is False
    assert not dist.is_initialized()


def test_shard_encode_without_a_group_is_one_ranks_encode():
    from gfx_imagecompress_tpu_torch.dist.sharded import (
        gather_words, gather_words_global, shard_encode)
    name, blocks = _blocks("bc1_45")
    want_w, want_e = _encoder(name)(torch.from_numpy(blocks))
    words, err, mse = shard_encode(_encoder(name), blocks, device="cpu")
    np.testing.assert_array_equal(gather_words(words),
                                  want_w.numpy().view(np.uint32))
    np.testing.assert_array_equal(gather_words_global(words),
                                  gather_words(words))
    np.testing.assert_array_equal(err.numpy(), want_e.numpy())
    assert mse == want_e.double().sum().item() / (45 * 16)


def test_pad_to_multiple_replicates_block_zero():
    from gfx_imagecompress_tpu_torch.dist.sharded import pad_to_multiple
    x = torch.arange(5 * 16, dtype=torch.float32).reshape(5, 16)
    p, n = pad_to_multiple(x, 4)
    assert n == 5 and tuple(p.shape) == (8, 16)
    assert torch.equal(p[:5], x) and torch.equal(p[5:], x[:1].expand(3, 16))
    same, n = pad_to_multiple(x, 5)
    assert same is x and n == 5


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
