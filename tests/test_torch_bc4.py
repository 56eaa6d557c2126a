"""Port's plain BC4/BC5 encoders vs the JAX package's Pallas entries.

The JAX side runs as its own tests run it on the CPU (interpret mode,
``tile=8``), at the shapes those tests already compile. Tolerance: the words
are BIT-IDENTICAL (as tests/test_bc4_pallas.py holds the Pallas kernel to its
XLA twin); the error agrees to rtol 1e-5 (XLA sums the 16 pixels in another
order than the port's left-to-right chain).
"""
from functools import lru_cache

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gfx_imagecompress_tpu.kernels.bc4_pallas import (
    encode_bc4_blocks_pallas, encode_bc5_blocks_pallas)
from gfx_imagecompress_tpu_torch.decode.bcn import (decode_bc4_block,
                                                    decode_bc5)
from gfx_imagecompress_tpu_torch.kernels.bc4 import (
    _SORT16, encode_bc4_blocks, encode_bc4_blocks_plain, encode_bc5_blocks)


def _hard(n):
    """n scalar blocks of hard cases: solid, two-level, adjacent levels,
    exact 0/1, values at .5 of an 8-bit step, a full ramp."""
    r = np.random.default_rng(77)
    v = r.random((n, 16), dtype=np.float32)
    v[0] = 0.0
    v[1] = 1.0
    v[2] = r.integers(0, 2, 16)
    v[3] = 0.5
    v[4] = np.where(r.integers(0, 2, 16) > 0, 0.25, 0.75)
    v[5] = (100 + r.integers(0, 2, 16)) / 255.0
    v[6] = np.arange(16) / 15.0
    v[7] = (np.arange(16) + 0.5) / 255.0
    v[8] = np.where(np.arange(16) < 3, 0.0, 0.6 + 0.01 * np.arange(16))
    v[9] = np.where(np.arange(16) > 12, 1.0, 0.3 + 0.01 * np.arange(16))
    return v.astype(np.float32)


@lru_cache(maxsize=None)
def _vals(case):
    rng = np.random.default_rng(42)
    if case == "random24":
        return rng.random((24, 16), dtype=np.float32)
    if case == "random16":
        rng.random((24, 16), dtype=np.float32)
        return rng.random((16, 16), dtype=np.float32)
    if case == "tail5":
        return rng.random((5, 16), dtype=np.float32)
    if case == "hard24":
        return _hard(24)
    raise KeyError(case)


@lru_cache(maxsize=None)
def _jax_bc4(case):
    w, e = encode_bc4_blocks_pallas(jnp.asarray(_vals(case)), tile=8)
    return np.asarray(w), np.asarray(e)


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("case", ["random24", "random16", "tail5", "hard24"])
def test_bc4_words_bit_identical_to_pallas(case):
    jw, je = _jax_bc4(case)
    tw, te = encode_bc4_blocks(torch.from_numpy(_vals(case)))
    assert tw.dtype == torch.int32 and tw.shape == jw.shape
    np.testing.assert_array_equal(_u32(tw), jw)
    np.testing.assert_allclose(te.numpy(), je, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("case", ["random24", "hard24"])
def test_bc4_error_model_matches_decoder(case):
    vals = _vals(case)
    tw, te = encode_bc4_blocks(torch.from_numpy(vals))
    dec = decode_bc4_block(tw).numpy()
    rec = ((vals.astype(np.float64) * 255.0 - dec) ** 2).sum(axis=1)
    np.testing.assert_allclose(rec, te.numpy(), rtol=1e-4, atol=0.5)


def _blocks48(seed):
    rng = np.random.default_rng(seed)
    base = rng.random((48, 1, 4), np.float32)
    d = rng.normal(0, 0.07, (48, 16, 4)).astype(np.float32)
    return np.clip(base + d, 0, 1)


@lru_cache(maxsize=None)
def _jax_bc5(seed):
    w, e = encode_bc5_blocks_pallas(jnp.asarray(_blocks48(seed)), tile=8)
    return np.asarray(w), np.asarray(e)


@pytest.mark.parametrize("seed", [5, 21])
def test_bc5_words_bit_identical_to_pallas(seed):
    jw, je = _jax_bc5(seed)
    tw, te = encode_bc5_blocks(torch.from_numpy(_blocks48(seed)))
    np.testing.assert_array_equal(_u32(tw), jw)
    np.testing.assert_allclose(te.numpy(), je, rtol=1e-5, atol=1e-3)


def test_bc5_is_two_bc4_and_decodes_exactly():
    b = _blocks48(5)
    tw, te = encode_bc5_blocks(torch.from_numpy(b))
    wr, er = encode_bc4_blocks(torch.from_numpy(b[:, :, 0].copy()))
    wg, eg = encode_bc4_blocks(torch.from_numpy(b[:, :, 1].copy()))
    np.testing.assert_array_equal(tw.numpy(),
                                  np.concatenate([wr.numpy(), wg.numpy()], 1))
    np.testing.assert_array_equal(te.numpy(), (er + eg).numpy())
    dec = decode_bc5(tw).numpy()
    rec = ((b[..., :2].astype(np.float64) * 255.0 - dec) ** 2).sum((1, 2))
    np.testing.assert_allclose(rec, te.numpy(), rtol=1e-4, atol=0.5)


def test_bit31_survives_int32_storage():
    """Index 5's low bit lands on bit 31 of word 0: the int32 storage must
    carry it as a sign bit, not lose or saturate it."""
    tw, _ = encode_bc4_blocks(torch.from_numpy(_vals("random24")))
    w0 = _u32(tw)[:, 0]
    assert (w0 >> 31).any() and not (w0 >> 31).all()
    assert (tw[:, 0] < 0).any()


def test_budgets_are_live_arguments():
    v = torch.from_numpy(_vals("random24"))
    _, e_full = encode_bc4_blocks(v)
    _, e_none = encode_bc4_blocks(v, iters=0, radius=0, rounds=0)
    assert e_full.sum() < e_none.sum()


def test_wrapper_takes_plain_version_on_cpu_and_checks_shape():
    v = torch.from_numpy(_vals("tail5"))
    a = encode_bc4_blocks(v)
    b = encode_bc4_blocks_plain(v)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError):
        encode_bc4_blocks(torch.zeros(4, 15))
    with pytest.raises(ValueError):
        encode_bc5_blocks(torch.zeros(4, 16, 1))


def test_cuda_sorting_network_is_the_python_one():
    """csrc/bc4_search.cuh spells out the compare-exchange pairs; they must
    be the ones the plain version generates."""
    import re
    from pathlib import Path
    import gfx_imagecompress_tpu_torch as pkg
    src = (Path(pkg.__file__).parent / "csrc" / "bc4_search.cuh").read_text()
    body = re.search(r"PAIRS\[63\]\[2\] = \{(.*?)\};", src, re.S).group(1)
    pairs = [(int(a), int(b))
             for a, b in re.findall(r"\{(\d+), *(\d+)\}", body)]
    assert pairs == list(_SORT16)
