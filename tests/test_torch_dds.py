"""Port's DDS container vs the JAX package's: same file bytes, round trip."""
import numpy as np
import pytest
import torch

import gfx_imagecompress_tpu as jgic
import gfx_imagecompress_tpu_torch as tgic
from gfx_imagecompress_tpu.io import dds as jdds
from gfx_imagecompress_tpu_torch import convert
from gfx_imagecompress_tpu_torch.io import dds as tdds

FORMATS = [("BC1_UNORM", 2), ("BC2_SRGB", 4), ("BC3_UNORM", 4),
           ("BC4_SNORM", 2), ("BC5_UNORM", 4), ("BC7_SRGB", 4),
           ("BC6H_UFLOAT", 4)]


@pytest.mark.parametrize("fmt,wpb", FORMATS)
def test_write_compressed_same_bytes_and_round_trip(tmp_path, fmt, wpb):
    words = np.random.default_rng(6).integers(0, 2 ** 32, (2, 4, 65, wpb),
                                              dtype=np.uint32)
    jci = jgic.CompressedImage(words, jgic.BlockFormat[fmt], 257, 13, 2)
    tci = convert.compressed_from_reference(words, fmt, 257, 13, 2,
                                            device="cpu")
    jdds.write_compressed(str(tmp_path / "j.dds"), jci)
    tdds.write_compressed(str(tmp_path / "t.dds"), tci)
    assert (tmp_path / "j.dds").read_bytes() == (tmp_path / "t.dds").read_bytes()
    back = tdds.read_compressed(str(tmp_path / "j.dds"), device="cpu")
    assert back.format.name == fmt
    assert (back.width, back.height, back.slices) == (257, 13, 2)
    assert back.blocks.dtype == torch.int32
    assert torch.equal(back.blocks, tci.blocks)


@pytest.mark.parametrize("dtype", ["rgba8", "rgba16f", "rgba32f"])
def test_write_image_same_bytes(tmp_path, dtype):
    arr = np.random.default_rng(7).random((9, 7, 3), dtype=np.float32)
    jdds.write_image(str(tmp_path / "j.dds"), jgic.Image.from_array(arr),
                     dtype)
    tdds.write_image(str(tmp_path / "t.dds"),
                     tgic.Image.from_array(arr, device="cpu"), dtype)
    assert (tmp_path / "j.dds").read_bytes() == (tmp_path / "t.dds").read_bytes()


def test_read_rejects_non_dds(tmp_path):
    p = tmp_path / "x.dds"
    p.write_bytes(b"\0" * 200)
    with pytest.raises(ValueError):
        tdds.read(str(p))
