"""The partition shortlist (K3): the port's plain version against the JAX
package's Pallas kernel in interpret mode, and the wrapper's contract.

The same numpy blocks go through ``_estimate_topk_rows(..., interpret=True)``,
laid out as the JAX entry lays them out, and through ``estimate_topk`` on the
CPU. Tolerance: the partition ids are equal on every block. The content is
photo-like and noise blocks, whose estimates are well apart: where estimates
are rounding noise around zero (a two-colour block split exactly along a
shape) XLA on the CPU computes ``x / count`` as ``x * (1 / count)`` and can
rank such ties otherwise.
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu.kernels.bc7_full_pallas import _estimate_topk_rows
from gfx_imagecompress_tpu_torch.kernels import bc7_est
from gfx_imagecompress_tpu_torch.tables.bc7_tables import P2, P3

from conftest import photo_rgba

CONFIGS = {
    "rgb_2sub_bounds": dict(chans=3, subsets=2, plist=(0, 1, 13), levels=8,
                            k=2, estimator="bounds"),
    "rgb_3sub_bounds": dict(chans=3, subsets=3, plist=(0, 5, 11, 20),
                            levels=4, k=2, estimator="bounds"),
    "rgba_2sub_pca": dict(chans=4, subsets=2, plist=(0, 13, 26, 40),
                          levels=4, k=3, estimator="pca"),
}


def _blocks():
    img = photo_rgba(16, 32, seed=5)
    img[..., 3] = np.random.default_rng(1).random((16, 32), np.float32)
    b = img.reshape(4, 4, 8, 4, 4).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 4)
    noise = np.random.default_rng(2).random((32, 16, 4), dtype=np.float32)
    return np.ascontiguousarray(np.concatenate([b, noise]), np.float32)


@lru_cache(maxsize=None)
def _both(name):
    cfg = CONFIGS[name]
    b = _blocks()
    n = b.shape[0]
    sub, lane = 1, 8
    xt = jnp.asarray(b).transpose(2, 1, 0).reshape(64, n // 8, sub, lane)
    rows, k = _estimate_topk_rows(
        xt, n // 8, sub, lane, cfg["chans"], cfg["subsets"], cfg["plist"],
        cfg["levels"], cfg["k"], True, cfg["estimator"])
    want = np.asarray(rows).reshape(k, n).T
    got = bc7_est.estimate_topk(torch.from_numpy(b), **cfg)
    return want, got


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ids_equal_the_pallas_kernel_on_every_block(name):
    want, got = _both(name)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == want.shape == (64, CONFIGS[name]["k"])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ids_are_distinct_members_of_the_list(name):
    _, got = _both(name)
    plist = set(CONFIGS[name]["plist"])
    for row in got.tolist():
        assert set(row) <= plist and len(set(row)) == len(row)


def test_equal_estimates_keep_list_order():
    """A solid block fits every partition exactly: the first k of the list."""
    b = torch.full((5, 16, 4), 0.25)
    for plist in ((7, 3, 40, 2), (63, 0, 1)):
        got = bc7_est.estimate_topk(b, chans=3, subsets=2, plist=plist,
                                    levels=8, k=3)
        assert got.tolist() == [list(plist[:3])] * 5


@pytest.mark.parametrize("subsets,table,shape", [(2, P2, 13), (2, P2, 26),
                                                 (3, P3, 4), (3, P3, 11)])
def test_a_block_split_along_a_shape_ranks_that_shape_first(subsets, table,
                                                            shape):
    rng = np.random.default_rng(shape)
    cols = rng.random((3, 4), np.float32)
    sub = bc7_est.subset_rows(table[shape], subsets)
    b = cols[sub] + rng.normal(0, 0.004, (16, 4)).astype(np.float32)
    b = torch.from_numpy(np.clip(b, 0, 1).astype(np.float32))[None]
    got = bc7_est.estimate_topk(b, chans=3, subsets=subsets,
                                plist=tuple(range(16 if subsets == 3 else 64)),
                                levels=8, k=1)
    assert got.tolist() == [[shape]]


def test_k_is_cut_to_the_list_length():
    b = torch.from_numpy(_blocks()[:8])
    got = bc7_est.estimate_topk(b, chans=3, subsets=2, plist=(4, 9), levels=8,
                                k=4)
    assert tuple(got.shape) == (8, 2)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_nothing():
    b = torch.from_numpy(_blocks()[:8])
    cfg = CONFIGS["rgb_2sub_bounds"]
    before = dict(bc7_est.LAUNCHES)
    assert torch.equal(bc7_est.estimate_topk(b, **cfg),
                       bc7_est.estimate_topk_plain(b, **cfg))
    assert bc7_est.LAUNCHES == before


@pytest.mark.parametrize("bad", [
    dict(chans=2), dict(subsets=1), dict(subsets=4), dict(plist=()),
    dict(plist=(0, 64)), dict(levels=1), dict(k=0), dict(estimator="svd"),
], ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_wrapper_rejects_what_it_does_not_take(bad):
    cfg = dict(CONFIGS["rgb_2sub_bounds"], **bad)
    with pytest.raises(ValueError):
        bc7_est.estimate_topk(torch.zeros((2, 16, 4)), **cfg)


def test_wrapper_rejects_a_wrong_shape():
    with pytest.raises(ValueError):
        bc7_est.estimate_topk(torch.zeros((2, 15, 4)),
                              **CONFIGS["rgb_2sub_bounds"])
    with pytest.raises(ValueError):          # 4 channels asked, 3 given
        bc7_est.estimate_topk(torch.zeros((2, 16, 3)),
                              **CONFIGS["rgba_2sub_pca"])


def test_sqrt32_is_correctly_rounded():
    """The plain versions take square roots through ``sqrt32`` because
    PyTorch's float32 ``sqrt`` on the CPU is not always correctly rounded."""
    x = np.random.default_rng(0).random(50000, np.float32) * 50000
    x[0] = np.float32(47617.1953125)
    got = bc7_est.sqrt32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(x))
    assert got.dtype == np.float32


def test_div_scalar_is_a_true_division():
    x = torch.arange(1, 2000, dtype=torch.float32) * 0.37
    for d in (3.0, 7.0, 12.0, 14.0):
        np.testing.assert_array_equal(bc7_est.div_scalar(x, d).numpy(),
                                      x.numpy() / np.float32(d))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_barred_blocks_get_the_lists_first_ids(name):
    """A barred block is not ranked: it gets the list's first k ids; every
    other block gets the ids it gets without a bar."""
    cfg = CONFIGS[name]
    b = torch.from_numpy(_blocks())
    bar = torch.zeros(b.shape[0], dtype=torch.bool)
    bar[::3] = True
    bar[-5:] = True
    free = bc7_est.estimate_topk(b, **cfg)
    got = bc7_est.estimate_topk(b, **cfg, bar=bar)
    first = torch.tensor(cfg["plist"][:cfg["k"]], dtype=torch.int32)
    assert (got[bar] == first).all()
    assert torch.equal(got[~bar], free[~bar])
    assert (free[bar] != first).any(dim=1).any()
    every = torch.ones_like(bar)
    assert (bc7_est.estimate_topk_plain(b, **cfg, bar=every) == first).all()


@pytest.mark.parametrize("bad", [torch.zeros(3, dtype=torch.bool),
                                 torch.zeros(64, dtype=torch.uint8)],
                         ids=["length", "dtype"])
def test_wrapper_rejects_a_wrong_bar(bad):
    b = torch.from_numpy(_blocks())
    with pytest.raises(ValueError):
        bc7_est.estimate_topk(b, **CONFIGS["rgb_2sub_bounds"], bar=bad)
