"""Port's BC1-BC5 decoders vs the JAX package's decoders AND its native C++
oracle, on random words - bit-exact. Random words cover both BC1 modes
(c0 > c1 and c0 <= c1) and both BC4 ramps; a few blocks pin the edge cases.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gfx_imagecompress_tpu import native
from gfx_imagecompress_tpu.decode import bcn as jdec
from gfx_imagecompress_tpu_torch.decode import bcn as tdec

N = 512


def _words(wpb, seed):
    w = np.random.default_rng(seed).integers(0, 2 ** 32, (N, wpb),
                                             dtype=np.uint32)
    # pin: equal endpoints, all-ones (bit 31 set everywhere), zeros
    w[0] = 0
    w[1] = 0xFFFFFFFF
    w[2, 0] = 0x12341234
    if wpb == 4:
        w[3, 2] = 0xABCDABCD
    return w


def _t(words):
    return torch.from_numpy(words.view(np.int32).copy())


def _modes_covered(words, col):
    c0 = words[:, col] & 0xFFFF
    c1 = words[:, col] >> 16
    return (c0 > c1).any() and (c0 <= c1).any()


CASES = [
    ("bc1", 2, lambda w: tdec.decode_bc1(w), lambda w: jdec.decode_bc1(w),
     lambda w: native.decode_bc1(w)),
    ("bc1_four", 2, lambda w: tdec.decode_bc1(w, force_four=True),
     lambda w: jdec.decode_bc1(w, force_four=True),
     lambda w: native.decode_bc1(w, force_four=True)),
    ("bc2", 4, tdec.decode_bc2, jdec.decode_bc2, native.decode_bc2),
    ("bc3", 4, tdec.decode_bc3, jdec.decode_bc3, native.decode_bc3),
    ("bc4", 2, lambda w: tdec.decode_bc4(w)[:, :, 0],
     lambda w: jdec.decode_bc4(w)[:, :, 0], native.decode_bc4),
    ("bc5", 4, tdec.decode_bc5, jdec.decode_bc5, native.decode_bc5),
]


@pytest.mark.parametrize("name,wpb,tfn,jfn,nfn", CASES,
                         ids=[c[0] for c in CASES])
def test_decode_matches_jax(name, wpb, tfn, jfn, nfn):
    words = _words(wpb, seed=11)
    got = tfn(_t(words))
    assert got.dtype == torch.int32
    want = np.asarray(jfn(jnp.asarray(words)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,wpb,tfn,jfn,nfn", CASES,
                         ids=[c[0] for c in CASES])
def test_decode_matches_native_oracle(name, wpb, tfn, jfn, nfn):
    words = _words(wpb, seed=12)
    got = tfn(_t(words)).numpy()
    want = nfn(np.ascontiguousarray(words)).astype(np.int32)
    np.testing.assert_array_equal(got, want)


def test_random_words_cover_both_modes():
    assert _modes_covered(_words(2, 11), 0)          # BC1 4- and 3-colour
    w = _words(2, 11)
    a0, a1 = w[:, 0] & 0xFF, (w[:, 0] >> 8) & 0xFF
    assert (a0 > a1).any() and (a0 <= a1).any()      # BC4 8- and 6-point


def test_extract_handles_bit31_and_straddle():
    from gfx_imagecompress_tpu_torch import bitpack
    w = np.array([[0x80000001, 0xC0000003]], dtype=np.uint32)
    t = _t(w)
    assert bitpack.extract(t, 31, 1).item() == 1
    assert bitpack.extract(t, 0, 32).item() == 0x80000001
    assert bitpack.extract(t, 30, 4).item() == 0b1110   # straddles words
    assert bitpack.extract(t, 62, 2).item() == 3
