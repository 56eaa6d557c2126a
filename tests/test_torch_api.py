"""The slice as a whole: ``compress()`` for BC1-BC5 through both packages.

The same numpy image goes through the JAX package and, via ``convert.py``,
through the port (on the CPU, where the wrappers run the plain versions).
Tolerance: same ``format``, dimensions and grid shape; the serialized bytes
equal on at least 90% of the blocks; for BC4/BC5 every block's decoded error
equal to the JAX package's (rtol 1e-5), so a block that differs is a tie; the
PSNR of the port's output, decoded by the JAX package's decoder, within
0.05 dB of the JAX package's own. At the full 1024-block tile XLA on the CPU
sums the 16 pixels in another order than the port's left-to-right chain, which
flips exact ties such as an 8-point and a 6-point ramp of equal error.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

import gfx_imagecompress_tpu as jgic
import gfx_imagecompress_tpu_torch as tgic
from gfx_imagecompress_tpu.decode import decode_image as jdecode
from gfx_imagecompress_tpu_torch import api as tapi
from gfx_imagecompress_tpu_torch import convert
from gfx_imagecompress_tpu_torch.decode import decode_image as tdecode

from conftest import checker_rgb, photo_rgba, psnr

CODECS = ["DXBC1", "DXBC2", "DXBC3", "DXBC4", "DXBC5"]
SIZES = {"32x32": (32, 32), "13x29": (13, 29)}


def _image(size):
    h, w = SIZES[size]
    img = photo_rgba(h, w, seed=h * 100 + w)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img[..., 3] = np.clip(0.5 + 0.45 * np.sin(x * 0.4) * np.cos(y * 0.3), 0, 1)
    return img


@lru_cache(maxsize=None)
def _both(codec, size):
    arr = _image(size)
    jimg = jgic.Image.from_array(arr)
    jout = jgic.compress(jgic.CompressType[codec], jimg)
    timg = convert.image_from_reference(np.asarray(jimg.data), jimg.srgb,
                                        jimg.signed, jimg.hdr, device="cpu")
    tout = tgic.compress(tgic.CompressType[codec], timg)
    return arr, jout, tout


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("codec", CODECS)
def test_compress_matches_jax_package(codec, size):
    arr, jout, tout = _both(codec, size)
    assert tout.format.name == jout.format.name
    assert tout.format.value == jout.format.value
    assert (tout.width, tout.height, tout.slices) == (
        jout.width, jout.height, jout.slices)
    assert tuple(tout.blocks.shape) == tuple(jout.blocks.shape)
    assert (tout.stored_width, tout.stored_height, tout.blocks_x,
            tout.blocks_y) == (jout.stored_width, jout.stored_height,
                               jout.blocks_x, jout.blocks_y)
    jb, tb = jout.tobytes(), tout.tobytes()
    assert len(jb) == len(tb)
    bpb = 8 if codec in ("DXBC1", "DXBC4") else 16
    same = (np.frombuffer(jb, np.uint8).reshape(-1, bpb)
            == np.frombuffer(tb, np.uint8).reshape(-1, bpb)).all(axis=1)
    assert same.mean() >= 0.9
    if codec in ("DXBC4", "DXBC5"):
        nch = 1 if codec == "DXBC4" else 2
        src = np.asarray(arr, np.float64)[None, ..., :nch] * 255.0

        def block_err(dec):
            d = (np.asarray(dec, np.float64) - src) ** 2
            h, w = d.shape[1:3]
            d = np.pad(d, ((0, 0), (0, -h % 4), (0, -w % 4), (0, 0)))
            return d.reshape(1, d.shape[1] // 4, 4, d.shape[2] // 4, 4,
                             nch).sum(axis=(2, 4, 5))

        np.testing.assert_allclose(block_err(tdecode(tout).numpy()),
                                   block_err(jdecode(jout)),
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("codec", CODECS)
def test_psnr_under_the_jax_decoder(codec, size):
    arr, jout, tout = _both(codec, size)
    # the port's blocks, carried back and decoded by the JAX package
    back = jgic.CompressedImage(convert.compressed_to_numpy(tout),
                                jout.format, tout.width, tout.height,
                                tout.slices)
    dec_t = np.asarray(jdecode(back))
    dec_j = np.asarray(jdecode(jout))
    nch = dec_j.shape[-1]
    src = np.rint(arr[None, ..., :nch] * 255.0)
    assert abs(psnr(dec_t, src) - psnr(dec_j, src)) <= 0.05
    # and the port's own decoder agrees with the JAX package's, bit for bit
    np.testing.assert_array_equal(tdecode(tout).numpy(), dec_t)


@lru_cache(maxsize=None)
def _punch_both():
    img = checker_rgb(32, 32)
    y, x = np.mgrid[0:32, 0:32]
    img[..., 3] = ((x // 4 + y // 4) % 2).astype(np.float32)
    img[::5, ::3, 3] = np.float32(128 / 255.0)      # exactly at the threshold
    img[1::5, ::3, 3] = np.float32(127 / 255.0)     # just below it
    jout = jgic.compress_amd_bc1(
        jgic.Image.from_array(img),
        options=jgic.BC1Options(use_alpha=True, alpha_threshold=128))
    tout = tgic.compress_amd_bc1(
        tgic.Image.from_array(img, device="cpu"),
        options=convert.options_from_reference(
            jgic.BC1Options(use_alpha=True, alpha_threshold=128)))
    return img, jout, tout


def test_punch_through_threshold_pixel_lands_on_the_same_side():
    img, jout, tout = _punch_both()
    dec_t = tdecode(tout).numpy()
    dec_j = np.asarray(jdecode(jout))
    np.testing.assert_array_equal(dec_t[..., 3], dec_j[..., 3])
    opaque = np.rint(img[..., 3] * 255.0) >= 128
    assert ((dec_t[0, ..., 3] > 127) == opaque).all()
    same = (np.frombuffer(jout.tobytes(), np.uint8).reshape(-1, 8)
            == np.frombuffer(tout.tobytes(), np.uint8).reshape(-1, 8))
    assert same.all(axis=1).mean() >= 0.9


def test_srgb_and_signed_pick_the_format():
    arr = checker_rgb(8, 8)
    img = tgic.Image.from_array(arr, srgb=True, device="cpu")
    assert tapi.compress_amd_bc1(img).format == tgic.BlockFormat.BC1_SRGB
    assert tapi.compress_amd_bc2(img).format == tgic.BlockFormat.BC2_SRGB
    assert tapi.compress_amd_bc3(img).format == tgic.BlockFormat.BC3_SRGB
    img = tgic.Image.from_array(arr, signed=True, device="cpu")
    assert tapi.compress_amd_bc4(img).format == tgic.BlockFormat.BC4_SNORM
    assert tapi.compress_amd_bc5(img).format == tgic.BlockFormat.BC5_SNORM


def test_option_plumbing_mirrors_the_jax_package(monkeypatch):
    """BC1 passes iters, b3d, use_alpha, threshold/255, adaptive and leaves
    passes alone; BC2/BC3 pass passes=2 under b3d_refinement and no b3d."""
    seen = {}

    def spy(name, n_words):
        def fn(blocks, **kw):
            seen[name] = kw
            n = blocks.shape[0]
            return (torch.zeros((n, n_words), dtype=torch.int32),
                    torch.zeros(n))
        return fn

    monkeypatch.setattr(tapi, "encode_bc1_blocks", spy("bc1", 2))
    monkeypatch.setattr(tapi, "encode_bc2_blocks", spy("bc2", 4))
    monkeypatch.setattr(tapi, "encode_bc3_blocks", spy("bc3", 4))
    img = tgic.Image.from_array(checker_rgb(8, 8), device="cpu")
    amd = tgic.AMDBackendOptions(b3d_refinement=True, refinement_steps=3,
                                 adaptive_colour_weights=True)
    tapi.compress_amd_bc1(img, amd, tgic.BC1Options(True, 100))
    tapi.compress_amd_bc2(img, amd)
    tapi.compress_amd_bc3(img, amd)
    assert seen["bc1"] == dict(
        weights=(0.3086, 0.6094, 0.0820), iters=5, b3d=True, use_alpha=True,
        alpha_threshold=100 / 255.0, adaptive=True)
    for k in ("bc2", "bc3"):
        assert seen[k] == dict(weights=(0.3086, 0.6094, 0.0820), iters=5,
                               passes=2, adaptive=True)
    # use_alpha needs an alpha channel
    rgb = tgic.Image.from_array(checker_rgb(8, 8)[..., :3], device="cpu")
    tapi.compress_amd_bc1(rgb, None, tgic.BC1Options(True, 100))
    assert seen["bc1"]["use_alpha"] is False and seen["bc1"]["iters"] == 3


def test_amd_options_are_live_end_to_end():
    img = tgic.Image.from_array(photo_rgba(32, 32, seed=3), device="cpu")
    base = tgic.compress_amd_bc1(img).tobytes()
    for amd in (tgic.AMDBackendOptions(b3d_refinement=True),
                tgic.AMDBackendOptions(adaptive_colour_weights=True),
                tgic.AMDBackendOptions(refinement_steps=0)):
        assert tgic.compress_amd_bc1(img, amd).tobytes() != base


KINDS = {
    "rgba": (checker_rgb(8, 8), {}),
    "gray": (checker_rgb(8, 8)[..., :1], {}),
    "rg": (checker_rgb(8, 8)[..., :2], {}),
    "rgb": (checker_rgb(8, 8)[..., :3], {}),
    "hdr": (checker_rgb(8, 8), {"hdr": True}),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_pick_compression_type_equals_jax_package(kind):
    arr, kw = KINDS[kind]
    jimg = jgic.Image.from_array(arr, **kw)
    timg = tgic.Image.from_array(arr, device="cpu", **kw)
    for bits in range(0x20):
        want = jgic.pick_compression_type(jgic.PickFlags(bits), jimg)
        got = tgic.pick_compression_type(tgic.PickFlags(bits), timg)
        assert got.name == want.name and got.value == want.value


def test_compress_chunked_progress_and_cancel():
    src = photo_rgba(64, 64, seed=8)
    img = tgic.Image.from_array(src, device="cpu")
    seen = []
    out = tgic.compress_chunked(tgic.CompressType.DXBC1, img,
                                progress=lambda p: seen.append(p) or False,
                                rows_per_chunk=32)
    assert seen == [50.0, 100.0]
    full = tgic.compress(tgic.CompressType.DXBC1, img)
    assert out.format == full.format
    assert torch.equal(out.blocks, full.blocks)
    calls = []
    assert tgic.compress_chunked(
        tgic.CompressType.DXBC1, img,
        progress=lambda p: calls.append(p) or True,
        rows_per_chunk=32) is None
    assert calls == [50.0]
    assert tgic.compress_chunked(tgic.CompressType.ASTC, img) is None


@pytest.mark.parametrize("name", ["ASTC", "ETC_RGB", "ETC2_RGB",
                                  "ETC_RGBA_EXPLICIT",
                                  "ETC_RGBA_INTERPOLATED", "NONE"])
def test_unimplemented_codecs_return_none(name):
    img = tgic.Image.from_array(checker_rgb(8, 8), device="cpu")
    assert tgic.compress(tgic.CompressType[name], img) is None


# ------------------------------------------------ the fast BC7 slice ---
# compress(DXBC7, fast=True) runs the default budget (64 partitions, top-4,
# uber 4), which the JAX package cannot compile in interpret mode on a CPU in
# the time a test has; so the whole call is not compared against the JAX
# package here. The searches are, at small budgets, in test_torch_bc7_est.py
# and test_torch_bc7_fast.py; here the port's output is decoded by both
# packages' decoders.

BC7_SIZES = {"16x16": (16, 16), "13x9": (13, 9)}
BC7_ENTRIES = {
    "compress_fast": lambda img: tgic.compress(tgic.CompressType.DXBC7, img,
                                               fast=True),
    "richgel_fast_rgb": lambda img: tgic.compress_richgel999_bc7(
        img, tgic.RichGel999Options(fast=True, perceptual=False)),
}


@lru_cache(maxsize=None)
def _bc7(entry, size, srgb=False):
    h, w = BC7_SIZES[size]
    arr = photo_rgba(h, w, seed=h * 10 + w)
    img = tgic.Image.from_array(arr, srgb=srgb, device="cpu")
    return arr, BC7_ENTRIES[entry](img)


@pytest.mark.parametrize("size", list(BC7_SIZES))
@pytest.mark.parametrize("entry", list(BC7_ENTRIES))
def test_bc7_fast_container(entry, size):
    arr, out = _bc7(entry, size)
    h, w = BC7_SIZES[size]
    by, bx = (h + 3) // 4, (w + 3) // 4
    assert out.format == tgic.BlockFormat.BC7_UNORM
    assert (out.width, out.height, out.slices) == (w, h, 1)
    assert tuple(out.blocks.shape) == (1, by, bx, 4)
    assert out.blocks.dtype == torch.int32
    assert len(out.tobytes()) == by * bx * 16
    assert tuple(tdecode(out).shape) == (1, h, w, 4)


@pytest.mark.parametrize("size", list(BC7_SIZES))
@pytest.mark.parametrize("entry", list(BC7_ENTRIES))
def test_bc7_fast_psnr_under_both_decoders(entry, size):
    arr, out = _bc7(entry, size)
    back = jgic.CompressedImage(convert.compressed_to_numpy(out),
                                jgic.BlockFormat.BC7_UNORM, out.width,
                                out.height, out.slices)
    dec_j = np.asarray(jdecode(back))
    dec_t = tdecode(out).numpy()
    src = np.rint(arr[None] * 255.0)
    assert abs(psnr(dec_j, src) - psnr(dec_t, src)) <= 0.05
    np.testing.assert_array_equal(dec_t, dec_j)     # same words, same decode
    assert psnr(dec_t[..., :3], src[..., :3]) > 33.0
    assert (dec_t[..., 3] >= 254).all()      # mode 6 with p-bit 0 gives 254


def test_bc7_fast_srgb_flag_picks_the_format():
    _, out = _bc7("compress_fast", "13x9", True)
    assert out.format == tgic.BlockFormat.BC7_SRGB
    _, lin = _bc7("compress_fast", "13x9")
    assert out.tobytes() == lin.tobytes()


@pytest.mark.parametrize("srgb", [False, True], ids=["unorm", "srgb"])
def test_bc7_fast_dds_round_trip(srgb, tmp_path):
    from gfx_imagecompress_tpu_torch.io import dds
    _, out = _bc7("compress_fast", "13x9", srgb)
    path = tmp_path / "t.dds"
    dds.write_compressed(str(path), out)
    back = dds.read_compressed(str(path), device="cpu")
    assert back.format == out.format
    assert (back.width, back.height, back.slices) == (9, 13, 1)
    assert torch.equal(back.blocks, out.blocks)


def test_bc7_container_crosses_both_ways():
    _, out = _bc7("compress_fast", "16x16")
    words = convert.compressed_to_numpy(out)
    assert words.dtype == np.uint32 and words.shape == (1, 4, 4, 4)
    again = convert.compressed_from_reference(words, "BC7_UNORM", 16, 16,
                                              device="cpu")
    assert again.format == out.format and torch.equal(again.blocks,
                                                      out.blocks)
    jci = jgic.CompressedImage(words, jgic.BlockFormat.BC7_UNORM, 16, 16, 1)
    assert jci.tobytes() == out.tobytes()


def test_richgel_options_reach_the_encoder(monkeypatch):
    seen = []

    def spy(blocks, **kw):
        seen.append((tuple(blocks.shape), kw))
        n = blocks.shape[0]
        return torch.zeros((n, 4), dtype=torch.int32), torch.zeros(n)

    monkeypatch.setattr(tapi, "encode_bc7_fast_blocks", spy)
    rgb = tgic.Image.from_array(checker_rgb(8, 8)[..., :3], device="cpu")
    tgic.compress(tgic.CompressType.DXBC7, rgb, fast=True)
    tgic.compress_richgel999_bc7(rgb, convert.options_from_reference(
        jgic.RichGel999Options(perceptual=False, fast=True)))
    # an image without alpha reaches the encoder as opaque RGBA; fast=True of
    # compress() selects the entry, not the entry's fast budget
    assert seen == [((4, 16, 4), dict(fast=False, perceptual=True)),
                    ((4, 16, 4), dict(fast=True, perceptual=False))]


def test_compress_chunked_takes_the_fast_bc7_path():
    img = tgic.Image.from_array(photo_rgba(16, 16, seed=4), device="cpu")
    full = tgic.compress(tgic.CompressType.DXBC7, img, fast=True)
    out = tgic.compress_chunked(tgic.CompressType.DXBC7, img,
                                rows_per_chunk=8, fast=True)
    assert out.format == full.format and torch.equal(out.blocks, full.blocks)


# ------------------------------------------------ the full BC7 slice ---
# compress(DXBC7) runs the top tier (quality 1.0), which the JAX package cannot
# compile in interpret mode on a CPU in the time a test has; the searches are
# compared at small budgets in test_torch_bc7_full.py. Here the port's output
# is decoded by both packages' decoders, and the option plumbing is held to
# the JAX entry's.

FULL_ENTRIES = {
    "compress": lambda img: tgic.compress(tgic.CompressType.DXBC7, img),
    "amd_bc7": lambda img: tgic.compress_amd_bc7(img),
}


@lru_cache(maxsize=None)
def _bc7_full(entry, size, srgb=False):
    h, w = BC7_SIZES[size]
    arr = photo_rgba(h, w, seed=h * 10 + w)
    img = tgic.Image.from_array(arr, srgb=srgb, device="cpu")
    return arr, FULL_ENTRIES[entry](img)


@pytest.mark.parametrize("size", list(BC7_SIZES))
@pytest.mark.parametrize("entry", list(FULL_ENTRIES))
def test_bc7_full_container(entry, size):
    arr, out = _bc7_full(entry, size)
    h, w = BC7_SIZES[size]
    by, bx = (h + 3) // 4, (w + 3) // 4
    assert out.format == tgic.BlockFormat.BC7_UNORM
    assert (out.width, out.height, out.slices) == (w, h, 1)
    assert tuple(out.blocks.shape) == (1, by, bx, 4)
    assert out.blocks.dtype == torch.int32
    assert len(out.tobytes()) == by * bx * 16
    assert tuple(tdecode(out).shape) == (1, h, w, 4)


@pytest.mark.parametrize("size", list(BC7_SIZES))
def test_bc7_full_entries_agree(size):
    _, a = _bc7_full("compress", size)
    _, b = _bc7_full("amd_bc7", size)
    assert torch.equal(a.blocks, b.blocks)


@pytest.mark.parametrize("size", list(BC7_SIZES))
def test_bc7_full_psnr_under_both_decoders(size):
    arr, out = _bc7_full("compress", size)
    back = jgic.CompressedImage(convert.compressed_to_numpy(out),
                                jgic.BlockFormat.BC7_UNORM, out.width,
                                out.height, out.slices)
    dec_j = np.asarray(jdecode(back))
    dec_t = tdecode(out).numpy()
    src = np.rint(arr[None] * 255.0)
    assert psnr(dec_j, src) == psnr(dec_t, src)
    np.testing.assert_array_equal(dec_t, dec_j)
    _, fast = _bc7("compress_fast", size)
    assert psnr(dec_t[..., :3], src[..., :3]) >= psnr(
        tdecode(fast).numpy()[..., :3], src[..., :3])


def test_bc7_full_srgb_flag_picks_the_format():
    _, out = _bc7_full("compress", "13x9", True)
    assert out.format == tgic.BlockFormat.BC7_SRGB
    _, lin = _bc7_full("compress", "13x9")
    assert out.tobytes() == lin.tobytes()


@pytest.mark.parametrize("srgb", [False, True], ids=["unorm", "srgb"])
def test_bc7_full_dds_round_trip(srgb, tmp_path):
    from gfx_imagecompress_tpu_torch.io import dds
    _, out = _bc7_full("compress", "13x9", srgb)
    path = tmp_path / "t.dds"
    dds.write_compressed(str(path), out)
    back = dds.read_compressed(str(path), device="cpu")
    assert back.format == out.format
    assert (back.width, back.height, back.slices) == (9, 13, 1)
    assert torch.equal(back.blocks, out.blocks)


FULL_OPTIONS = {
    "defaults": (None, None),
    "amd_mask": (jgic.AMDBackendOptions(mode_mask=0x5A), None),
    "bc7_options": (None, jgic.BC7Options(0.6, False, True, 0.3, 0x7F)),
    "both": (jgic.AMDBackendOptions(mode_mask=0x0F),
             jgic.BC7Options(0.4, True, False, 0.9, 0xC3)),
}


@pytest.mark.parametrize("case", list(FULL_OPTIONS))
def test_bc7_full_options_reach_the_encoder_as_in_jax(case, monkeypatch):
    """The port's compress_amd_bc7 hands encode_bc7_blocks the keyword
    arguments the JAX entry's partial hands encode_bc7_blocks_pallas."""
    import jax.numpy as jnp
    from gfx_imagecompress_tpu.kernels import bc7_full_pallas
    seen = {"jax": [], "port": []}

    def spy(side, zeros):
        def fn(blocks, **kw):
            seen[side].append((tuple(blocks.shape), kw))
            return zeros(blocks.shape[0])
        return fn

    monkeypatch.setattr(bc7_full_pallas, "encode_bc7_blocks_pallas",
                        spy("jax", lambda n: (jnp.zeros((n, 4), jnp.uint32),
                                              jnp.zeros((n,)))))
    monkeypatch.setattr(tapi, "encode_bc7_blocks",
                        spy("port", lambda n: (
                            torch.zeros((n, 4), dtype=torch.int32),
                            torch.zeros(n))))
    amd, opt = FULL_OPTIONS[case]
    arr = checker_rgb(8, 12)
    jgic.compress_amd_bc7(jgic.Image.from_array(arr), amd, opt)
    tgic.compress_amd_bc7(
        tgic.Image.from_array(arr, device="cpu"),
        None if amd is None else convert.options_from_reference(amd),
        None if opt is None else convert.options_from_reference(opt))
    if amd is None and opt is None:
        jgic.compress(jgic.CompressType.DXBC7, jgic.Image.from_array(arr))
        tgic.compress(tgic.CompressType.DXBC7,
                      tgic.Image.from_array(arr, device="cpu"))
    assert seen["port"] == seen["jax"] and seen["port"]


def test_compress_chunked_takes_the_full_bc7_path():
    img = tgic.Image.from_array(photo_rgba(8, 16, seed=4), device="cpu")
    full = tgic.compress(tgic.CompressType.DXBC7, img)
    out = tgic.compress_chunked(tgic.CompressType.DXBC7, img,
                                rows_per_chunk=4)
    assert out.format == full.format and torch.equal(out.blocks, full.blocks)


# ------------------------------------------------ the BC6H slice ---
# compress(DXBC6H) runs the top tier (quality 1.0), which the JAX package cannot
# compile in interpret mode on a CPU in the time a test has; the search is
# compared at quality 0.3 in test_torch_bc6h.py. Here the containers, both
# decoders and the option rule are held to the JAX package's.

BC6H_SIZES = {"16x16": (16, 16), "13x9": (13, 9)}
BC6H_ENTRIES = {
    "compress": lambda img: tgic.compress(tgic.CompressType.DXBC6H, img),
    "amd_bc6h": lambda img: tgic.compress_amd_bc6h(img),
}


@lru_cache(maxsize=None)
def _bc6h(entry, size, signed):
    from test_bc6h import hdr_image
    h, w = BC6H_SIZES[size]
    arr = hdr_image(h, w, seed=h * 10 + w, signed=signed)
    img = tgic.Image.from_array(arr, signed=signed, hdr=True, device="cpu")
    return arr, BC6H_ENTRIES[entry](img)


@pytest.mark.parametrize("signed", [False, True], ids=["ufloat", "sfloat"])
@pytest.mark.parametrize("entry", list(BC6H_ENTRIES))
def test_bc6h_container(entry, signed):
    arr, out = _bc6h(entry, "13x9", signed)
    by, bx = 4, 3
    assert out.format == (tgic.BlockFormat.BC6H_SFLOAT if signed
                          else tgic.BlockFormat.BC6H_UFLOAT)
    assert (out.width, out.height, out.slices) == (9, 13, 1)
    assert tuple(out.blocks.shape) == (1, by, bx, 4)
    assert out.blocks.dtype == torch.int32
    assert len(out.tobytes()) == by * bx * 16
    dec = tdecode(out)
    assert dec.dtype == torch.float32 and tuple(dec.shape) == (1, 13, 9, 3)
    assert torch.isfinite(dec).all()


@pytest.mark.parametrize("signed", [False, True], ids=["ufloat", "sfloat"])
def test_bc6h_entries_agree(signed):
    _, a = _bc6h("compress", "16x16", signed)
    _, b = _bc6h("amd_bc6h", "16x16", signed)
    assert a.format == b.format and torch.equal(a.blocks, b.blocks)


@pytest.mark.parametrize("signed", [False, True], ids=["ufloat", "sfloat"])
def test_bc6h_decodes_alike_under_both_decoders(signed):
    arr, out = _bc6h("compress", "16x16", signed)
    back = jgic.CompressedImage(convert.compressed_to_numpy(out),
                                jgic.BlockFormat[out.format.name], out.width,
                                out.height, out.slices)
    dec_j = np.asarray(jdecode(back))
    dec_t = tdecode(out).numpy()
    assert dec_j.dtype == dec_t.dtype == np.float32
    np.testing.assert_array_equal(dec_t, dec_j)
    # an HDR encode keeps the image: relative error well under 5% per pixel
    rel = np.abs(dec_t[0] - arr) / np.maximum(np.abs(arr), 1e-3)
    assert np.median(rel) < 0.05


BC6H_OPTIONS = {
    "bc6h_options": (jgic.AMDBackendOptions(mode_mask=0x5A),
                     jgic.BC6HOptions(False, 0.4, 0x3C0F)),
    "amd_only": (jgic.AMDBackendOptions(mode_mask=0x7E), None),
    "neither": (None, None),
}


@pytest.mark.parametrize("case", list(BC6H_OPTIONS))
def test_bc6h_options_reach_the_encoder_as_in_jax(case, monkeypatch):
    """The port's compress_amd_bc6h hands encode_bc6h_blocks the arguments
    the JAX entry hands encode_bc6h_blocks_pallas: BC6HOptions' quality and
    16-bit mask, else the AMD options' mask at quality 1.0, else all modes."""
    import jax.numpy as jnp
    from gfx_imagecompress_tpu.kernels import bc6h_pallas
    seen = {"jax": [], "port": []}

    def spy(side, zeros):
        def fn(blocks, **kw):
            seen[side].append((tuple(blocks.shape), kw))
            return zeros(blocks.shape[0])
        return fn

    monkeypatch.setattr(bc6h_pallas, "encode_bc6h_blocks_pallas",
                        spy("jax", lambda n: (jnp.zeros((n, 4), jnp.uint32),
                                              jnp.zeros((n,)))))
    monkeypatch.setattr(tapi, "encode_bc6h_blocks",
                        spy("port", lambda n: (
                            torch.zeros((n, 4), dtype=torch.int32),
                            torch.zeros(n))))
    amd, opt = BC6H_OPTIONS[case]
    arr = np.abs(checker_rgb(8, 12)) * 7.0
    for signed in (False, True):
        jgic.compress_amd_bc6h(jgic.Image.from_array(arr, signed=signed,
                                                     hdr=True), amd, opt)
        tgic.compress_amd_bc6h(
            tgic.Image.from_array(arr, signed=signed, hdr=True,
                                  device="cpu"),
            None if amd is None else convert.options_from_reference(amd),
            None if opt is None else convert.options_from_reference(opt))
    if amd is None and opt is None:
        jgic.compress(jgic.CompressType.DXBC6H,
                      jgic.Image.from_array(arr, hdr=True))
        tgic.compress(tgic.CompressType.DXBC6H,
                      tgic.Image.from_array(arr, hdr=True, device="cpu"))
    assert seen["port"] == seen["jax"] and len(seen["port"]) >= 2


def test_pick_then_compress_takes_bc6h_for_hdr():
    from test_bc6h import hdr_image
    img = tgic.Image.from_array(hdr_image(8, 8, seed=2), hdr=True,
                                device="cpu")
    ctype = tgic.pick_compression_type(tgic.PickFlags.ALLOW_DXBC6AND7, img)
    assert ctype == tgic.CompressType.DXBC6H
    out = tgic.compress(ctype, img)
    assert out.format == tgic.BlockFormat.BC6H_UFLOAT
    assert tuple(tdecode(out).shape) == (1, 8, 8, 3)


def test_compress_chunked_takes_the_bc6h_path():
    from test_bc6h import hdr_image
    img = tgic.Image.from_array(hdr_image(8, 12, seed=4, signed=True),
                                signed=True, hdr=True, device="cpu")
    full = tgic.compress(tgic.CompressType.DXBC6H, img)
    seen = []
    out = tgic.compress_chunked(tgic.CompressType.DXBC6H, img,
                                progress=lambda p: seen.append(p) or False,
                                rows_per_chunk=4)
    assert seen == [50.0, 100.0]
    assert out.format == full.format == tgic.BlockFormat.BC6H_SFLOAT
    assert torch.equal(out.blocks, full.blocks)


@pytest.mark.parametrize("signed", [False, True], ids=["uf16", "sf16"])
def test_bc6h_dds_round_trip(signed, tmp_path):
    from gfx_imagecompress_tpu_torch.io import dds
    from gfx_imagecompress_tpu.io import dds as jdds
    _, out = _bc6h("compress", "13x9", signed)
    path = tmp_path / "t.dds"
    dds.write_compressed(str(path), out)
    raw = path.read_bytes()
    # DXGI_FORMAT_BC6H_UF16 = 95, BC6H_SF16 = 96 in the DX10 header
    assert int.from_bytes(raw[128:132], "little") == (96 if signed else 95)
    back = dds.read_compressed(str(path), device="cpu")
    assert back.format == out.format
    assert (back.width, back.height, back.slices) == (9, 13, 1)
    assert torch.equal(back.blocks, out.blocks)
    jback = jdds.read_compressed(str(path))
    assert jback.format.name == out.format.name
    assert jback.tobytes() == out.tobytes()


def test_same_public_names_and_enums():
    assert sorted(tgic.__all__) == sorted(jgic.__all__)
    for enum_name in ("CompressType", "PickFlags", "BlockFormat"):
        je, te = getattr(jgic, enum_name), getattr(tgic, enum_name)
        assert {m.name: m.value for m in je} == {m.name: m.value for m in te}
    from gfx_imagecompress_tpu import formats as jf
    from gfx_imagecompress_tpu_torch import formats as tf
    assert {k.name: (v.bytes_per_block, v.words_per_block, v.channels)
            for k, v in jf.BLOCK_FORMAT_INFO.items()} == {
        k.name: (v.bytes_per_block, v.words_per_block, v.channels)
        for k, v in tf.BLOCK_FORMAT_INFO.items()}
    assert [tf.block_count(d) for d in range(1, 40)] == [
        jf.block_count(d) for d in range(1, 40)]


@pytest.mark.parametrize("obj", [
    jgic.BC1Options(True, 77),
    jgic.AMDBackendOptions(True, True, 3, 0x5A),
    jgic.RichGel999Options(False, True),
    jgic.BC7Options(0.6, False, False, 0.3, 0x7F),
    jgic.BC6HOptions(True, 0.4, 0x1234),
], ids=lambda o: type(o).__name__)
def test_options_from_reference_copies_every_field(obj):
    import dataclasses
    got = convert.options_from_reference(obj)
    assert type(got).__module__.startswith("gfx_imagecompress_tpu_torch")
    assert type(got).__name__ == type(obj).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(obj)
    assert dataclasses.asdict(type(got)()) == dataclasses.asdict(type(obj)())


def test_options_from_reference_rejects_other_objects():
    with pytest.raises(TypeError):
        convert.options_from_reference(object())


def test_compressed_containers_cross_both_ways():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 2 ** 32, (2, 3, 5, 4), dtype=np.uint32)
    ci = convert.compressed_from_reference(words, "BC3_UNORM", 20, 12, 2,
                                           device="cpu")
    assert ci.blocks.dtype == torch.int32
    np.testing.assert_array_equal(convert.compressed_to_numpy(ci), words)
    jci = jgic.CompressedImage(words, jgic.BlockFormat.BC3_UNORM, 20, 12, 2)
    assert ci.tobytes() == jci.tobytes()
    by_value = convert.compressed_from_reference(
        words, jgic.BlockFormat.BC3_UNORM.value, 20, 12, 2, device="cpu")
    assert by_value.format == ci.format


def test_uint8_input_is_normalised_like_the_jax_package():
    arr = np.random.default_rng(5).integers(0, 256, (8, 8, 4), dtype=np.uint8)
    j = np.asarray(jgic.Image.from_array(arr).data)
    t = tgic.Image.from_array(arr, device="cpu").data.numpy()
    np.testing.assert_array_equal(t, j)
    with pytest.raises(ValueError):
        tgic.Image.from_array(np.zeros((4, 4)), device="cpu")
