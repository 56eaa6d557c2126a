"""The port's native decode oracle (``native.py`` over its own copy of
``csrc/bcn_decode.cpp``) against the JAX package's oracle, and the port's
PyTorch decoders against the port's oracle - bit for bit.

- the two oracles on random bitstreams (all seven decoders, both BC1 modes
  and BC6H's signs) and on blocks the port's encoders emit;
- ``decode/bc7.py`` in each of the 8 modes and ``decode/bc6h.py`` in each of
  the 14 modes, forced through the encoders' ``mode_mask`` and through the
  mode bits of random words;
- the oracle's layouts include equal to what its generator writes, and its
  code equal to the JAX package's below the header comment.
"""
import importlib.util
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu import native as jnative
from gfx_imagecompress_tpu_torch import native
from gfx_imagecompress_tpu_torch.decode import bcn
from gfx_imagecompress_tpu_torch.decode.bc6h import decode_bc6h_half
from gfx_imagecompress_tpu_torch.decode.bc7 import block_modes, decode_bc7
from gfx_imagecompress_tpu_torch.kernels import bc1, bc4, bc6h, bc7_fast
from gfx_imagecompress_tpu_torch.kernels import bc7_full
from gfx_imagecompress_tpu_torch.tables.bc6h_tables import BC6H_MODES

from conftest import photo_rgba

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "gfx_imagecompress_tpu_torch" / "csrc"


def _words(n, w, seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, size=(n, w), dtype=np.uint64).astype(np.uint32)


def _t(words):
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


DECODERS = {
    "bc1": (2, lambda m, w: m.decode_bc1(w)),
    "bc1_four": (2, lambda m, w: m.decode_bc1(w, force_four=True)),
    "bc2": (4, lambda m, w: m.decode_bc2(w)),
    "bc3": (4, lambda m, w: m.decode_bc3(w)),
    "bc4": (2, lambda m, w: m.decode_bc4(w)),
    "bc5": (4, lambda m, w: m.decode_bc5(w)),
    "bc7": (4, lambda m, w: m.decode_bc7(w)),
    "bc6h_uf": (4, lambda m, w: m.decode_bc6h(w, signed=False)),
    "bc6h_sf": (4, lambda m, w: m.decode_bc6h(w, signed=True)),
}


@pytest.mark.parametrize("name", list(DECODERS))
def test_oracle_equals_jax_oracle_on_random_bitstreams(name):
    wpb, fn = DECODERS[name]
    words = _words(1024, wpb, seed=len(name) * 7 + wpb)
    got = fn(native, words)
    np.testing.assert_array_equal(got, fn(jnative, words))
    # the port's int32 word storage decodes the same as uint32 words
    np.testing.assert_array_equal(fn(native, _t(words)), got)


@lru_cache(maxsize=None)
def _emitted():
    """Words of each format, as the port's plain versions emit them."""
    img = photo_rgba(32, 32, seed=31)
    img[..., 3] = np.linspace(0, 1, 32 * 32).reshape(32, 32)
    from gfx_imagecompress_tpu_torch.pipeline.blocks import image_to_blocks
    b = image_to_blocks(torch.from_numpy(img[None]))
    hdr = torch.from_numpy(np.exp(photo_rgba(16, 16, seed=34)[..., :3] * 3))
    hb = image_to_blocks(hdr[None])
    return {
        "bc1": bc1.encode_bc1_blocks(b)[0],
        "bc1_four": bc1.encode_bc1_blocks(b, allow_three=False)[0],
        "bc2": bc1.encode_bc2_blocks(b)[0],
        "bc3": bc1.encode_bc3_blocks(b)[0],
        "bc4": bc4.encode_bc4_blocks(b[:, :, 3].contiguous())[0],
        "bc5": bc4.encode_bc5_blocks(b[:, :, :2].contiguous())[0],
        "bc7": torch.cat([
            bc7_fast.encode_bc7_fast_blocks(b)[0],
            bc7_full.encode_bc7_blocks(b[:16], quality=0.25)[0]]),
        "bc6h_uf": bc6h.encode_bc6h_blocks(hb, quality=0.3)[0],
        "bc6h_sf": bc6h.encode_bc6h_blocks(-hb, signed=True, quality=0.3)[0],
    }


PORT_DECODERS = {
    "bc1": lambda w: bcn.decode_bc1(w),
    "bc1_four": lambda w: bcn.decode_bc1(w, force_four=True),
    "bc2": bcn.decode_bc2,
    "bc3": bcn.decode_bc3,
    "bc4": lambda w: bcn.decode_bc4(w)[:, :, 0],
    "bc5": bcn.decode_bc5,
    "bc7": decode_bc7,
    "bc6h_uf": lambda w: decode_bc6h_half(w, signed=False),
    "bc6h_sf": lambda w: decode_bc6h_half(w, signed=True),
}


@pytest.mark.parametrize("name", list(DECODERS))
def test_emitted_blocks_decode_alike_in_both_oracles_and_the_port(name):
    _, fn = DECODERS[name]
    words = _emitted()[name]
    got = fn(native, words)
    np.testing.assert_array_equal(got, fn(jnative, words.numpy().view(
        np.uint32)))
    port = PORT_DECODERS[name](words).numpy()
    np.testing.assert_array_equal(port.astype(got.dtype), got)


def _bc7_words_in_mode(mode, n=256, seed=0):
    w = _words(n, 4, seed + 100 + mode)
    w[:, 0] = (w[:, 0] & ~np.uint32((1 << (mode + 1)) - 1)) | np.uint32(
        1 << mode)
    return w


@pytest.mark.parametrize("mode", range(8))
def test_bc7_decoder_equals_oracle_in_each_mode(mode):
    # encoded: the full search forced into the mode
    img = photo_rgba(16, 16, seed=40 + mode)
    if mode in (4, 5, 6, 7):
        img[..., 3] = np.linspace(0.2, 1.0, 16)[None, :]
    from gfx_imagecompress_tpu_torch.pipeline.blocks import image_to_blocks
    b = image_to_blocks(torch.from_numpy(img[None]))
    words, _ = bc7_full.encode_bc7_blocks(
        b, quality=0.25, mode_mask=1 << mode, colour_restrict=False,
        alpha_restrict=False)
    assert (block_modes(words) == mode).all()
    np.testing.assert_array_equal(decode_bc7(words).numpy().astype(np.uint8),
                                  native.decode_bc7(words))
    # random words with the mode's bits
    w = _bc7_words_in_mode(mode)
    np.testing.assert_array_equal(decode_bc7(_t(w)).numpy().astype(np.uint8),
                                  native.decode_bc7(w))


def _bc6h_mode_of(words):
    w0 = words[:, 0].numpy().view(np.uint32)
    out = np.zeros(len(w0), np.int64)
    for m in BC6H_MODES:
        code = w0 & ((1 << m.code_bits) - 1)
        out[code == m.code] = m.mode
    return out


@lru_cache(maxsize=None)
def _hdr_blocks(signed):
    img = np.exp(photo_rgba(8, 16, seed=61)[..., :3] * 4.0)
    if signed:
        img[..., 1] *= -1.0
    from gfx_imagecompress_tpu_torch.pipeline.blocks import image_to_blocks
    return image_to_blocks(torch.from_numpy(img[None].astype(np.float32)))


@pytest.mark.parametrize("signed", [False, True], ids=["uf", "sf"])
@pytest.mark.parametrize("mode", range(1, 15))
def test_bc6h_decoder_equals_oracle_in_each_mode(mode, signed):
    words, _ = bc6h.encode_bc6h_blocks(_hdr_blocks(signed), signed=signed,
                                       quality=0.3, mode_mask=1 << (mode - 1))
    assert (_bc6h_mode_of(words) == mode).all()
    got = decode_bc6h_half(words, signed=signed).numpy().astype(np.uint16)
    np.testing.assert_array_equal(got, native.decode_bc6h(words, signed))
    m = BC6H_MODES[mode - 1]
    w = _words(256, 4, seed=200 + mode)
    w[:, 0] = (w[:, 0] & ~np.uint32((1 << m.code_bits) - 1)) | np.uint32(
        m.code)
    got = decode_bc6h_half(_t(w), signed=signed).numpy().astype(np.uint16)
    np.testing.assert_array_equal(got, native.decode_bc6h(w, signed))


def _generator():
    spec = importlib.util.spec_from_file_location(
        "gen_bc6h_layouts", CSRC / "gen_bc6h_layouts.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def test_layouts_include_is_current():
    gen = _generator()
    assert (CSRC / "bc6h_layouts.inc").read_text() == gen.render_oracle()
    # the same segments as the JAX package's include, below its first line
    jax_inc = (ROOT / "gfx_imagecompress_tpu" / "csrc"
               / "bc6h_layouts.inc").read_text()
    assert (gen.render_oracle().splitlines()[1:]
            == jax_inc.splitlines()[1:])


def test_generator_writes_both_files(tmp_path):
    gen = _generator()
    gen.main(["gen", str(tmp_path)])
    assert (tmp_path / "bc6h_layouts.inc").read_text() == gen.render_oracle()
    assert (tmp_path / "bc6h_layouts.cuh").read_text() == gen.render()


def test_oracle_source_is_the_jax_packages_below_its_header():
    def body(path):
        text = path.read_text()
        return text[text.index("#include <cstdint>"):]

    assert body(CSRC / "bcn_decode.cpp") == body(
        ROOT / "gfx_imagecompress_tpu" / "csrc" / "bcn_decode.cpp")


def test_build_lands_in_the_build_directory_and_is_reused():
    info = native.ensure_built()
    path = Path(info["path"])
    assert path.parent == ROOT / "build" / "native"
    assert path.name == f"libbcn_decode-{native._digest()}.so"
    assert path.is_file()
    assert native.ensure_built()["path"] == info["path"]


def test_failed_build_raises(tmp_path, monkeypatch):
    (tmp_path / "bcn_decode.cpp").write_text("this is not C++\n")
    (tmp_path / "bc6h_layouts.inc").write_text("")
    monkeypatch.setattr(native, "CSRC", tmp_path)
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._build()
