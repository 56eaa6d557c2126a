"""Port vs JAX package: image <-> block-tensor layout, bit-exact.

Inputs are made with numpy from a seed and handed to both packages.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gfx_imagecompress_tpu.pipeline import blocks as jblocks
from gfx_imagecompress_tpu_torch.pipeline import blocks as tblocks

SHAPES = [(1, 16, 32, 4), (2, 257, 13, 3), (1, 13, 257, 4), (3, 5, 6, 1),
          (1, 1, 1, 2), (4, 8, 8, 4)]


def _img(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_image_to_blocks_matches(shape):
    img = _img(shape)
    want = np.asarray(jblocks.image_to_blocks(jnp.asarray(img)))
    got = tblocks.image_to_blocks(torch.from_numpy(img))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_pad_to_blocks_matches(shape):
    img = _img(shape, 1)
    want = np.asarray(jblocks.pad_to_blocks(jnp.asarray(img)))
    got = tblocks.pad_to_blocks(torch.from_numpy(img))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_blocks_to_image_roundtrip_matches(shape):
    img = _img(shape, 2)
    s, h, w, _ = shape
    blocks = tblocks.image_to_blocks(torch.from_numpy(img))
    back = tblocks.blocks_to_image(blocks, s, h, w)
    np.testing.assert_array_equal(back.numpy(), img)
    want = np.asarray(jblocks.blocks_to_image(
        jnp.asarray(blocks.numpy()), s, h, w))
    np.testing.assert_array_equal(back.numpy(), want)


@pytest.mark.parametrize("wpb", [2, 4])
@pytest.mark.parametrize("shape", [(1, 13, 257), (3, 32, 32)])
def test_packed_grid_matches(shape, wpb):
    s, h, w = shape
    n = s * ((h + 3) // 4) * ((w + 3) // 4)
    words = np.random.default_rng(3).integers(
        0, 2 ** 32, (n, wpb), dtype=np.uint32)
    want = np.asarray(jblocks.packed_to_grid(jnp.asarray(words), s, h, w, wpb))
    tw = torch.from_numpy(words.view(np.int32).copy())
    grid = tblocks.packed_to_grid(tw, s, h, w, wpb)
    np.testing.assert_array_equal(grid.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tblocks.grid_to_packed(grid).numpy(),
                                  tw.numpy())


def test_block_pixel_order_is_row_major():
    img = np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1)
    blocks = tblocks.image_to_blocks(torch.from_numpy(img))
    np.testing.assert_array_equal(blocks[0, :, 0].numpy(), np.arange(16))
