"""Port's plain BC2/BC3 encoders vs the JAX package's fused Pallas entries.

The JAX side runs in interpret mode with ``tile=8`` on the ``_blocks(48)``
fixture of tests/test_fused.py. Tolerance: the alpha halves (words 0-1: BC3's
scalar ramp, BC2's explicit 4-bit alpha) are BIT-IDENTICAL; the colour halves
(words 2-3) follow the BC1 bar - reported error decode-exact (rtol 1e-4,
atol 0.5), summed error within x1.001 + 1.0 both ways, at least 90% of the
blocks identical - because XLA on the CPU may reassociate where eager torch
does not and every candidate race is a strict compare.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gfx_imagecompress_tpu.kernels.bc1_pallas import (
    encode_bc2_blocks_pallas, encode_bc3_blocks_pallas)
from gfx_imagecompress_tpu_torch.decode.bcn import decode_bc2, decode_bc3
from gfx_imagecompress_tpu_torch.kernels.bc1 import (
    encode_bc1_blocks, encode_bc2_blocks, encode_bc3_blocks)
from gfx_imagecompress_tpu_torch.kernels.bc4 import encode_bc4_blocks

W = np.array([0.3086, 0.6094, 0.0820])
ENTRY = {"bc2": (encode_bc2_blocks_pallas, encode_bc2_blocks, decode_bc2),
         "bc3": (encode_bc3_blocks_pallas, encode_bc3_blocks, decode_bc3)}


def _blocks(seed, n=48):
    rng = np.random.default_rng(seed)
    base = rng.random((n, 1, 4), np.float32)
    d = rng.normal(0, 0.07, (n, 16, 4)).astype(np.float32)
    return np.clip(base + d, 0, 1)


@lru_cache(maxsize=None)
def _both(codec, seed):
    jfn, tfn, _ = ENTRY[codec]
    b = _blocks(seed)
    jw, je = jfn(jnp.asarray(b), tile=8)
    tw, te = tfn(torch.from_numpy(b))
    return b, np.asarray(jw), np.asarray(je), tw, te.numpy()


def _decoded_error(codec, b, tw):
    dec = ENTRY[codec][2](tw).numpy().astype(np.float64)
    src = b.astype(np.float64) * 255.0
    cerr = (((src[..., :3] - dec[..., :3]) ** 2) * W).sum(axis=(1, 2))
    alpha = np.rint(src[..., 3]) if codec == "bc2" else src[..., 3]
    return cerr + ((alpha - dec[..., 3]) ** 2).sum(axis=1)


PAIRS = [("bc3", 9), ("bc2", 13), ("bc3", 5), ("bc2", 5)]


@pytest.mark.parametrize("codec,seed", PAIRS)
def test_alpha_half_bit_identical_to_pallas(codec, seed):
    _, jw, _, tw, _ = _both(codec, seed)
    np.testing.assert_array_equal(tw.numpy().view(np.uint32)[:, :2],
                                  jw[:, :2])


@pytest.mark.parametrize("codec,seed", PAIRS)
def test_colour_half_matches_pallas(codec, seed):
    _, jw, je, tw, te = _both(codec, seed)
    same = (tw.numpy().view(np.uint32)[:, 2:] == jw[:, 2:]).all(axis=1)
    assert same.mean() >= 0.9
    assert te.sum() <= je.sum() * 1.001 + 1.0
    assert je.sum() <= te.sum() * 1.001 + 1.0


@pytest.mark.parametrize("codec,seed", PAIRS)
def test_error_is_decode_exact(codec, seed):
    b, _, _, tw, te = _both(codec, seed)
    np.testing.assert_allclose(_decoded_error(codec, b, tw), te,
                               rtol=1e-4, atol=0.5)


def test_bc3_is_bc4_alpha_plus_four_colour_bc1():
    b = _blocks(9)
    tw, te = encode_bc3_blocks(torch.from_numpy(b))
    cw, ce = encode_bc1_blocks(torch.from_numpy(b), allow_three=False)
    aw, ae = encode_bc4_blocks(torch.from_numpy(b[:, :, 3].copy()))
    np.testing.assert_array_equal(
        tw.numpy(), np.concatenate([aw.numpy(), cw.numpy()], 1))
    np.testing.assert_array_equal(te.numpy(), (ce + ae).numpy())


def test_bc2_alpha_rounding_of_the_reference():
    """4-bit alpha with the C++ library's rounding: c=127 -> 7, c=128 -> 8,
    c=255 -> 15, c=8 -> 0, c=9 -> 1 (amd_bcx_helpers.cpp:107-123)."""
    b = _blocks(13, n=4)
    vals = np.array([127, 128, 255, 8, 9, 0, 17, 26, 25, 136, 135, 144, 247,
                     246, 119, 120], np.float32) / 255.0
    b[0, :, 3] = vals
    tw, _ = encode_bc2_blocks(torch.from_numpy(b))
    w = tw.numpy().view(np.uint32)[0]
    nib = [(int(w[p // 8]) >> (4 * (p % 8))) & 15 for p in range(16)]
    c = np.rint(vals * 255.0).astype(int)
    hi = c >> 4
    want = np.minimum((c + np.where(hi < 8, 7, 8) - hi) >> 4, 15)
    assert nib == list(want)
    assert nib[:5] == [7, 8, 15, 0, 1]


@pytest.mark.parametrize("codec", ["bc2", "bc3"])
def test_passes_knob_is_live_and_decode_exact(codec):
    tfn = ENTRY[codec][1]
    b = _blocks(9)
    w1, e1 = tfn(torch.from_numpy(b), passes=1)
    w2, e2 = tfn(torch.from_numpy(b), passes=2)
    assert (w1 != w2).any()
    assert e2.sum() <= e1.sum() * 1.01      # tie-break may trade a little
    np.testing.assert_allclose(_decoded_error(codec, b, w2), e2.numpy(),
                               rtol=1e-4, atol=0.5)


def test_rgb_input_reads_as_opaque():
    b = _blocks(9)
    b[..., 3] = 1.0
    w4, _ = encode_bc3_blocks(torch.from_numpy(b))
    w3, _ = encode_bc3_blocks(torch.from_numpy(b[..., :3].copy()))
    assert torch.equal(w4, w3)
