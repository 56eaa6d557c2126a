"""The BC6H slice (K6): the port's plain search against the JAX package's
Pallas kernel in interpret mode, the decoder, the half conversion, the host
logic, the tables and the bit-field writer against the JAX package, and the
plain search against its own decoder at every tier and mode mask.

Against the Pallas kernel, the same numpy blocks go through
``encode_bc6h_blocks_pallas`` and through ``encode_bc6h_blocks`` on the CPU,
at the two configurations the JAX package's own tests compile
(``tests/test_bc6h_pallas.py``: ``hdr_image(8, 8, seed=71)``, ``tile=4``,
quality 0.3, unsigned and signed), so that one file's compile can serve the
other from the persistent cache. Each configuration is one test that runs all
four checks, so that no two workers compile the same program. Tolerance, the
JAX package's own bar between its two paths: the reported error equals the
error of the decoded words (``rtol 1e-4, atol 0.5``); the summed error is
within x1.001 + 1.0 both ways; at least 90% of the words are identical (the
share is printed, beside the share of blocks whose mode field matches) - XLA
on the CPU sums the 16 pixels in another order than the port's left-to-right
chain and multiplies by the reciprocal where the port divides by a constant
(the shape estimate's mean), either of which can flip a strict compare
between near-equal candidates.

No other configuration of the Pallas kernel is compiled here: its
interpret-mode compile takes minutes on a CPU even at quality 0.3. The other
tiers (the shake runs only above quality 0.8), the mode masks and the
fallback are held on the CPU by the plain version against its own decoder
(here) and by the host build of the CUDA search against the plain version
(``test_torch_bc6h_host_build.py``).
"""
import dataclasses
import importlib.util
from functools import lru_cache
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu import bitpack_dyn as jdyn
from gfx_imagecompress_tpu.decode import bc6h as jdec
from gfx_imagecompress_tpu.kernels import bc6h as jbc6h
from gfx_imagecompress_tpu.kernels import bc6h_pallas as jpallas
from gfx_imagecompress_tpu.pipeline.blocks import image_to_blocks
from gfx_imagecompress_tpu.tables import bc6h_tables as jtab
from gfx_imagecompress_tpu_torch import bitpack_dyn as tdyn
from gfx_imagecompress_tpu_torch.decode import bc6h as tdec
from gfx_imagecompress_tpu_torch.kernels import bc6h
from gfx_imagecompress_tpu_torch.tables import bc6h_tables as ttab

from test_bc6h import hdr_image
from test_torch_bc6h_host_build import CASES, mixed_hdr_blocks

CSRC = (Path(__file__).resolve().parent.parent
        / "gfx_imagecompress_tpu_torch" / "csrc")


def _signed_dec(hd):
    """Sign-magnitude half bits -> the signed integer they stand for."""
    hd = np.asarray(hd).astype(np.int64)
    return np.where(hd >= 0x8000, -(hd & 0x7FFF), hd)


def _decoded_error(blocks, words, signed):
    """Squared error of the decoded words in half-int space, per block."""
    hd = tdec.decode_bc6h_half(words, signed).numpy().astype(np.int64)
    if signed:
        hd = _signed_dec(hd)
    tgt = bc6h.f32_to_half_int(torch.as_tensor(blocks), signed).numpy()
    return ((tgt.astype(np.float64) - hd) ** 2).sum(axis=(1, 2))


def _mode_codes(words):
    w0 = np.asarray(words).view(np.uint32)[:, 0]
    return np.where((w0 & 3) < 2, w0 & 3, w0 & 0x1F)


# ------------------------------------------------- against the Pallas kernel ---

def _against_the_pallas_kernel(signed, quality):
    """The plain version and the Pallas kernel in interpret mode on the JAX
    tests' 8x8 HDR image at ``tile=4``, held to the JAX package's bars."""
    img = hdr_image(8, 8, seed=71, signed=signed)
    b = np.array(image_to_blocks(jnp.asarray(img[None])), np.float32)
    wj, ej = jpallas.encode_bc6h_blocks_pallas(jnp.asarray(b), tile=4,
                                               quality=quality, signed=signed)
    wj, ej = np.array(wj), np.array(ej)
    wt, et = bc6h.encode_bc6h_blocks(torch.from_numpy(b), signed=signed,
                                     quality=quality)
    # the reported error is the decoded error
    np.testing.assert_allclose(et.numpy(), _decoded_error(b, wt, signed),
                               rtol=1e-4, atol=0.5)
    # the summed error, both ways
    sj, st = float(ej.sum()), float(et.sum())
    assert st <= sj * 1.001 + 1.0 and sj <= st * 1.001 + 1.0
    # identical words, and the mode fields
    same = (wt.numpy().view(np.uint32) == wj).all(axis=1)
    mode_same = _mode_codes(wt.numpy()) == _mode_codes(wj)
    print(f"signed={signed} quality={quality}: {same.mean():.4f} of "
          f"{same.size} blocks identical, {mode_same.mean():.4f} with the "
          "same mode field")
    assert same.mean() >= 0.9


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_plain_version_against_the_pallas_kernel(signed):
    _against_the_pallas_kernel(signed, 0.3)


@pytest.mark.slow
@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_plain_version_against_the_pallas_kernel_with_the_shake(signed):
    """Quality 1.0, the only tier with the shake (``_shake_best_rows``,
    ``_shake_q_rows``): the plain version, which the CUDA kernel equals bit
    for bit, against the Pallas kernel. Its interpret-mode compile is much
    larger than quality 0.3's: run with RUN_SLOW=1."""
    _against_the_pallas_kernel(signed, 1.0)


def test_fallback_fixture_of_the_jax_package():
    """tests/test_bc6h.py's fallback fixture (transformed two-region modes
    only, on content whose deltas overflow every such mode) through the
    plain version, held to that test's own assertions."""
    r = np.random.default_rng(7)
    vals = np.where(r.random((64, 16, 3)) < 0.5, 60000.0, 1e-4)
    words, err = bc6h.encode_bc6h_blocks(
        torch.from_numpy(vals.astype(np.float32)), signed=False,
        mode_mask=0x1FF, quality=0.3)
    assert torch.isfinite(err).all()
    allowed = {0x00, 0x01, 0x02, 0x06, 0x0A, 0x0E, 0x12, 0x16, 0x1A}
    assert set(_mode_codes(words.numpy()).tolist()) <= allowed
    dec = tdec.decode_bc6h(words, signed=False).numpy()
    assert np.isfinite(dec).all()
    assert (dec >= 0.0).all() and (dec <= 65504.0).all()


# ------------------------------------------- the plain version on its own ---

@lru_cache(maxsize=None)
def _encoded(name, signed):
    _, quality, mask = next(c for c in CASES if c[0] == name)
    x = mixed_hdr_blocks(signed=signed)
    w, e = bc6h.encode_bc6h_blocks(torch.from_numpy(x), signed=signed,
                                   quality=quality, mode_mask=mask)
    return x, mask, w, e


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_reported_error_is_the_decoded_error(name, signed):
    x, mask, w, e = _encoded(name, signed)
    assert torch.isfinite(e).all()
    np.testing.assert_allclose(e.numpy(), _decoded_error(x, w, signed),
                               rtol=1e-4, atol=0.5)
    enabled = {m.code for m in ttab.BC6H_MODES if (mask >> (m.mode - 1)) & 1}
    assert set(_mode_codes(w.numpy()).tolist()) <= enabled


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_shake_never_loses(signed):
    """Quality 1.0 is quality 0.8 plus the shake of each race's winner,
    kept only where strictly better: no block gets worse."""
    _, _, _, e08 = _encoded("q08", signed)
    _, _, _, e1 = _encoded("q1", signed)
    assert (e1 <= e08).all()
    assert (e1 < e08).any()


# ------------------------------------------------- host logic against JAX ---

@pytest.mark.parametrize("quality", [0.0, 0.1, 0.3, 0.31, 0.5, 0.7, 0.71,
                                     0.8, 0.81, 1.0])
def test_budgets_are_the_jax_packages(quality):
    assert bc6h._budgets(quality) == jpallas._budgets(quality)


EDGES = np.array(
    [0.0, -0.0, 1.0, -1.0, 0.5, 65504.0, -65504.0, 65519.0, 65520.0,
     70000.0, -70000.0, np.inf, -np.inf, np.nan, -np.nan, 6.1e-5, 6.0e-5,
     5.96e-8, 2.98e-8, 3.0e-8, -5.96e-8, 1e-10, 1.0009765625, 1.00048828125,
     1.0014648, 2049.0, 2051.0, 123.456, -123.456, 3.4e38, -3.4e38, 1e-45],
    np.float32)


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_half_conversion_equals_jax_package(signed):
    r = np.random.default_rng(3)
    x = np.concatenate([
        EDGES, (r.standard_normal(4000) * np.exp(r.uniform(-20, 12, 4000)))
        .astype(np.float32)])
    want = np.asarray(jbc6h.f32_to_half_int(jnp.asarray(x), signed))
    got = bc6h.f32_to_half_int(torch.from_numpy(x), signed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        bc6h._to_work(got, signed).numpy(),
        np.asarray(jbc6h._to_work(jnp.asarray(want), signed)))


@pytest.mark.parametrize("mask", [0xFFFF, 0x1FF, 0x3C00, 0x200, 0x2000,
                                  0x3800, 0x100, 0x3DFF, 0x4FF, 0x3FFF, 0x400,
                                  0x1, 0x3, 0x800, 0x1000, 0x3000, 0x1C00,
                                  0x2100, 0x23FF, 0x3E00, 0x7FFF0100])
def test_fallback_rule_is_the_pallas_kernels(mask):
    """The pallas body adds the solid-mean candidate when every enabled mode
    is transformed, on the first enabled one-region mode, else the first
    two-region one."""
    two = [(mi, m) for mi, m in enumerate(jtab.BC6H_MODES)
           if m.regions == 2 and (mask >> (m.mode - 1)) & 1]
    one = [(mi, m) for mi, m in enumerate(jtab.BC6H_MODES)
           if m.regions == 1 and (mask >> (m.mode - 1)) & 1]
    allm = two + one
    want = ((one if one else two)[0][0]
            if allm and all(m.transformed for _, m in allm) else None)
    assert bc6h.fallback_mode(mask) == want


# ------------------------------------------------------ decoder against JAX ---

N_WORDS = 256
# the 14 mode codes and the four reserved 5-bit codes
CODES = [(m.code, m.code_bits) for m in jtab.BC6H_MODES] + [
    (c, 5) for c in (0x13, 0x17, 0x1B, 0x1F)]


def _words_with_code(code, bits, seed):
    w = np.random.default_rng(seed).integers(0, 2 ** 32, (N_WORDS, 4),
                                             dtype=np.uint32)
    w[:, 0] = (w[:, 0] & ~np.uint32((1 << bits) - 1)) | np.uint32(code)
    return w


@lru_cache(maxsize=None)
def _jax_decoded(signed):
    """The JAX decoder on every code's words at once (one pass of its
    eager ops)."""
    w = np.concatenate([_words_with_code(c, b, 100 + i)
                        for i, (c, b) in enumerate(CODES)])
    return w, np.asarray(jdec.decode_bc6h_half(jnp.asarray(w), signed))


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("k", range(len(CODES)),
                         ids=[f"code{c:02x}" for c, _ in CODES])
def test_decoder_equals_jax_package(k, signed):
    w, want = _jax_decoded(signed)
    sl = slice(k * N_WORDS, (k + 1) * N_WORDS)
    got = tdec.decode_bc6h_half(torch.from_numpy(w[sl].view(np.int32)),
                                signed)
    assert got.dtype == torch.int32 and tuple(got.shape) == (N_WORDS, 16, 3)
    np.testing.assert_array_equal(got.numpy(), want[sl])


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_decoder_equals_jax_package_on_encoded_blocks(signed):
    """Words from the port's own encoder (every mode the mixed blocks reach,
    at the top tier and under the masks), decoded to float32 by both."""
    words = torch.cat([_encoded(c[0], signed)[2] for c in CASES])
    want = np.asarray(jdec.decode_bc6h(
        jnp.asarray(words.numpy().view(np.uint32)), signed))
    got = tdec.decode_bc6h(words, signed)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_half_bits_to_f32_equals_jax_package():
    h = np.arange(0, 0x10000, dtype=np.int32)
    want = np.asarray(jdec.half_bits_to_f32(jnp.asarray(h)))
    got = tdec.half_bits_to_f32(torch.from_numpy(h)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan], want[~nan])


# ------------------------------------------------------------------ tables ---

@pytest.mark.parametrize("name", ["LAYOUTS", "FIELDS", "TWO_REGION_SHAPE_BIT",
                                  "TWO_REGION_INDEX_BIT",
                                  "ONE_REGION_INDEX_BIT"])
def test_table_equals_jax_package(name):
    assert getattr(ttab, name) == getattr(jtab, name)


def test_mode_table_equals_jax_package():
    assert [dataclasses.asdict(m) for m in ttab.BC6H_MODES] == [
        dataclasses.asdict(m) for m in jtab.BC6H_MODES]
    assert ttab.BC6HMode.__module__.startswith("gfx_imagecompress_tpu_torch")


def test_generated_layouts_header_is_current():
    spec = importlib.util.spec_from_file_location(
        "gen_bc6h_layouts", CSRC / "gen_bc6h_layouts.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert (CSRC / "bc6h_layouts.cuh").read_text() == gen.render()


# --------------------------------------------------------- bit-field writer ---

@pytest.mark.parametrize("width", ["fixed", "per_block"])
def test_insert_dyn_equals_jax_package(width):
    r = np.random.default_rng(9)
    n = 512
    off = r.integers(0, 128, n)
    nb = (np.full(n, 7) if width == "fixed"
          else np.minimum(r.integers(1, 33, n), 128 - off))
    off = np.minimum(off, 128 - nb)
    val = (r.integers(0, 2 ** 32, n, dtype=np.uint64)
           & ((np.uint64(1) << nb.astype(np.uint64)) - np.uint64(1)))
    words = np.zeros((n, 4), np.uint32)
    nbits = 7 if width == "fixed" else nb
    want = np.asarray(jdyn.insert_dyn(jnp.asarray(words),
                                      jnp.asarray(val.astype(np.uint32)),
                                      jnp.asarray(off), jnp.asarray(nbits)))
    got = tdyn.insert_dyn(torch.from_numpy(words.view(np.int32)),
                          torch.from_numpy(val.astype(np.int64)),
                          torch.from_numpy(off),
                          nbits if width == "fixed" else torch.from_numpy(nb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    back = tdyn.extract_dyn(got, torch.from_numpy(off),
                            torch.from_numpy(nb))
    np.testing.assert_array_equal(back.numpy(), val.astype(np.int64))
