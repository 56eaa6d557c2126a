"""The port's BC7 decoder against the JAX package's, bit for bit, on random
128-bit words forced into each of the 8 modes and into the reserved mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gfx_imagecompress_tpu_torch as tgic
from gfx_imagecompress_tpu.decode.bc7 import decode_bc7 as jdecode_bc7
from gfx_imagecompress_tpu_torch.decode import decode_image
from gfx_imagecompress_tpu_torch.decode.bc7 import block_modes, decode_bc7

N = 320


def _words_in_mode(mode, n=N, seed=0):
    """Random words whose low byte selects ``mode`` (8 = the reserved mode:
    low byte 0)."""
    w = np.random.default_rng(seed + mode).integers(0, 2 ** 32, (n, 4),
                                                    dtype=np.uint32)
    if mode < 8:
        w[:, 0] = (w[:, 0] & ~np.uint32((1 << (mode + 1)) - 1)) | np.uint32(
            1 << mode)
    else:
        w[:, 0] &= np.uint32(0xFFFFFF00)
    return w


def _storage(w):
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.parametrize("mode", range(9),
                         ids=[f"mode{m}" for m in range(8)] + ["reserved"])
def test_decode_equals_jax_package(mode):
    w = _words_in_mode(mode)
    want = np.asarray(jdecode_bc7(jnp.asarray(w)))
    got = decode_bc7(_storage(w))
    assert got.dtype == torch.int32 and tuple(got.shape) == (N, 16, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (block_modes(_storage(w)) == mode).all()
    if mode == 8:
        assert not got.any()
    if mode in (0, 1, 2, 3):            # opaque modes
        assert (got[..., 3] == 255).all()


def test_decode_of_mixed_modes_equals_jax_package():
    w = np.concatenate([_words_in_mode(m, 40, seed=50) for m in range(9)])
    np.random.default_rng(3).shuffle(w, axis=0)
    np.testing.assert_array_equal(decode_bc7(_storage(w)).numpy(),
                                  np.asarray(jdecode_bc7(jnp.asarray(w))))


def test_high_bit_words_are_read_as_unsigned():
    """Words are int32 storage of a uint32 pattern: bit 31 is data."""
    w = _words_in_mode(6, 64, seed=9) | np.uint32(0x80000000)
    np.testing.assert_array_equal(decode_bc7(_storage(w)).numpy(),
                                  np.asarray(jdecode_bc7(jnp.asarray(w))))


@pytest.mark.parametrize("fmt", ["BC7_UNORM", "BC7_SRGB"])
def test_decode_image_handles_bc7(fmt):
    w = _words_in_mode(6, 6, seed=70).reshape(1, 2, 3, 4)
    ci = tgic.CompressedImage(torch.from_numpy(w.view(np.int32)),
                              tgic.BlockFormat[fmt], 10, 7)
    img = decode_image(ci)
    assert tuple(img.shape) == (1, 7, 10, 4) and img.dtype == torch.int32
    blocks = decode_bc7(_storage(w.reshape(-1, 4))).reshape(2, 3, 4, 4, 4)
    full = blocks.permute(0, 2, 1, 3, 4).reshape(8, 12, 4)
    assert torch.equal(img[0], full[:7, :10])
