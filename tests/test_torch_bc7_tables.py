"""The port's copies of the BC7 tables and constants, the dynamic bit-field
reader and the field writers, each against the JAX package's; and the tables
the CUDA sources carry against the Python ones."""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu import bitpack as jbitpack
from gfx_imagecompress_tpu import bitpack_dyn as jdyn
from gfx_imagecompress_tpu.kernels import bc7_fast as jfast
from gfx_imagecompress_tpu.tables import bc7_tables as jtab
from gfx_imagecompress_tpu_torch import bitpack as tbitpack
from gfx_imagecompress_tpu_torch import bitpack_dyn as tdyn
from gfx_imagecompress_tpu_torch.kernels import bc7_fast as tfast
from gfx_imagecompress_tpu_torch.tables import bc7_tables as ttab

CSRC = (Path(__file__).resolve().parent.parent
        / "gfx_imagecompress_tpu_torch" / "csrc")


@pytest.mark.parametrize("name", ["P2", "P3", "ANCHOR2", "ANCHOR3_1",
                                  "ANCHOR3_2", "WEIGHTS2", "WEIGHTS3",
                                  "WEIGHTS4", "WEIGHTS_BY_BITS"])
def test_table_equals_jax_package(name):
    assert getattr(ttab, name) == getattr(jtab, name)


def test_mode_table_equals_jax_package():
    assert [dataclasses.asdict(m) for m in ttab.BC7_MODES] == [
        dataclasses.asdict(m) for m in jtab.BC7_MODES]
    assert ttab.BC7Mode.__module__.startswith("gfx_imagecompress_tpu_torch")


@pytest.mark.parametrize("subsets", [1, 2, 3])
def test_expanded_tables_equal_jax_package(subsets):
    np.testing.assert_array_equal(ttab.partition_table(subsets),
                                  jtab.partition_table(subsets))
    np.testing.assert_array_equal(ttab.anchor_table(subsets),
                                  jtab.anchor_table(subsets))
    with pytest.raises(ValueError):
        ttab.partition_table(4)


def test_fast_encoder_constants_equal_jax_package():
    assert tfast.FAST_PARTITIONS == jfast.FAST_PARTITIONS
    assert tfast.PERCEP_W == jfast.PERCEP_W
    np.testing.assert_array_equal(tfast._YCBCR_M, jfast._YCBCR_M)
    assert tfast._YCBCR_M.dtype == jfast._YCBCR_M.dtype
    # every entry is a multiple of 1/256 below 2: exact in float32
    assert (tfast._YCBCR_M * 256 == np.round(tfast._YCBCR_M * 256)).all()


@pytest.mark.parametrize("which", [0, 1, 2], ids=["lo", "hi", "err"])
def test_solid_table_equals_jax_package(which):
    t, j = tfast._mode1_solid_table()[which], jfast._mode1_solid_table()[which]
    assert t.dtype == j.dtype and t.shape == (256, 2)
    np.testing.assert_array_equal(t, j)


# ------------------------------------------------------------- bit fields ---

def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (n, 4),
                                                dtype=np.uint32)


def _storage(words):
    return torch.from_numpy(words.view(np.int32))


@pytest.mark.parametrize("case", ["random", "shift32", "width32", "last_word",
                                  "per_block_width"])
def test_extract_dyn_equals_jax_package(case):
    rng = np.random.default_rng(11)
    n = 512
    words = _words(n, 12)
    if case == "random":
        off = rng.integers(0, 120, n)
        nb = 7
    elif case == "shift32":         # offset % 32 == 0: the high part shifts 32
        off = rng.integers(0, 4, n) * 32
        nb = 5
    elif case == "width32":
        off = rng.integers(0, 97, n)
        nb = 32
    elif case == "last_word":       # no word above to borrow from
        off = rng.integers(96, 128, n)
        nb = 4
    else:
        off = rng.integers(0, 100, n)
        nb = rng.integers(1, 9, n)
    want = np.asarray(jdyn.extract_dyn(
        jnp.asarray(words), jnp.asarray(off, jnp.int32),
        nb if isinstance(nb, int) else jnp.asarray(nb, jnp.uint32)))
    got = tdyn.extract_dyn(
        _storage(words), torch.from_numpy(off),
        nb if isinstance(nb, int) else torch.from_numpy(nb))
    assert got.dtype == torch.int64 and (got >= 0).all()
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("start,nbits", [(0, 8), (7, 7), (28, 12), (63, 1),
                                         (64, 1), (90, 6), (96, 32), (125, 3)])
def test_field_or_equals_jax_package_and_reads_back(start, nbits):
    n = 64
    rng = np.random.default_rng(start * 40 + nbits)
    val = rng.integers(0, 2 ** 32, n, dtype=np.uint64)     # wider than nbits
    base = _words(n, 5)
    # clear the target field first so OR-ing equals writing
    cleared = np.asarray(base).copy()
    for b in range(start, start + nbits):
        cleared[:, b // 32] &= ~np.uint32(1 << (b % 32))
    want = np.asarray(jbitpack.field_or(jnp.asarray(cleared),
                                        jnp.asarray(val.astype(np.uint32)),
                                        start, nbits))
    got = tbitpack.field_or(_storage(cleared),
                            torch.from_numpy(val.astype(np.int64)), start,
                            nbits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    back = tbitpack.extract(got, start, nbits)
    np.testing.assert_array_equal(back.numpy(),
                                  (val & ((1 << nbits) - 1)).astype(np.int64))


def test_sink_equals_jax_package():
    n = 32
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 8, (n, 16))
    head = rng.integers(0, 64, n)
    js = jbitpack.Sink(n, 4)
    js.put(jnp.asarray(head), 2, 6).put_indices(jnp.asarray(idx), 70, 3)
    ts = tbitpack.Sink(n, 4)
    ts.put(torch.from_numpy(head), 2, 6).put_indices(torch.from_numpy(idx),
                                                     70, 3)
    np.testing.assert_array_equal(ts.words().numpy().view(np.uint32),
                                  np.asarray(js.words()))
    np.testing.assert_array_equal(
        tbitpack.extract_indices(ts.words(), 70, 3).numpy(), idx)


# -------------------------------------------- tables in the CUDA sources ---

def _c_array(text, name):
    body = re.search(rf"{name}\[\d+\] = \{{(.*?)\}};", text, re.S).group(1)
    return [int(v.rstrip("u"), 0) for v in re.findall(r"0x[0-9A-Fa-f]+u?|\d+",
                                                      body)]


@pytest.mark.parametrize("name", ["P2", "P3", "ANCHOR2", "ANCHOR3_1",
                                  "ANCHOR3_2"])
def test_cuda_header_tables_equal_the_python_tables(name):
    text = (CSRC / "bc7_common.cuh").read_text()
    assert tuple(_c_array(text, name)) == getattr(ttab, name)


def test_cuda_header_solid_table_equals_the_python_table():
    text = (CSRC / "bc7_common.cuh").read_text()
    packed = np.asarray(_c_array(text, "SOLID1")).reshape(256, 2)
    lo, hi, err = tfast._mode1_solid_table()
    np.testing.assert_array_equal(packed & 0xFF, lo)
    np.testing.assert_array_equal((packed >> 8) & 0xFF, hi)
    np.testing.assert_array_equal(packed >> 16, err.astype(np.int64))


def test_cuda_weight_formulas_give_the_weight_tables():
    """bc7_common.cuh computes the interpolation weights instead of storing
    them; the formulas are read from the source and evaluated here."""
    text = (CSRC / "bc7_common.cuh").read_text()
    for fn, table in (("weight4", ttab.WEIGHTS4), ("weight3", ttab.WEIGHTS3),
                      ("weight2", ttab.WEIGHTS2)):
        expr = re.search(rf"int {fn}\(int i\) \{{ return (.*?); \}}",
                         text).group(1)
        assert re.fullmatch(r"[\di\s()*+/]+", expr), expr
        got = tuple(eval(expr.replace("/", "//"), {"i": i})
                    for i in range(len(table)))
        assert got == table
