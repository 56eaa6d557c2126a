"""Port's plain BC1 encoder vs the JAX package's Pallas entry.

The JAX side runs as its own tests run it on the CPU (interpret mode,
``tile=8``) on the fixtures those tests use. Tolerance, the bar
tests/test_bc1_pallas.py sets between the JAX package's own two paths
(XLA on the CPU may reassociate where eager torch does not, and every
candidate race is a strict compare on sums of squares, so a tie can flip):
  - every block's reported error equals the error measured from the port's
    decoder on the emitted words (rtol 1e-4, atol 0.5);
  - summed error within x1.001 + 1.0 of the JAX package's, BOTH ways;
  - at least 90% of the blocks' words identical.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gfx_imagecompress_tpu.kernels.bc1_pallas import encode_bc1_blocks_pallas
from gfx_imagecompress_tpu.pipeline.blocks import image_to_blocks
from gfx_imagecompress_tpu_torch.decode.bcn import decode_bc1
from gfx_imagecompress_tpu_torch.kernels.bc1 import (
    encode_bc1_blocks, encode_bc1_blocks_plain)

from conftest import photo_rgba

W = np.array([0.3086, 0.6094, 0.0820])


def _photo_blocks(seed):
    return np.array(image_to_blocks(
        jnp.asarray(photo_rgba(16, 16, seed=seed)[None])))


def _punch_blocks(at_threshold: bool):
    img = photo_rgba(16, 16, seed=55)
    img[..., 3] = 1.0
    img[::3, ::2, 3] = 0.2          # punch holes
    if at_threshold:
        img[1::4, 1::4, 3] = 0.5    # exactly at the threshold: opaque
        img[2::4, 3::4, 3] = np.nextafter(np.float32(0.5), np.float32(0))
    return np.array(image_to_blocks(jnp.asarray(img[None])))


def _hard_blocks():
    """16 RGBA blocks of hard cases: solid, two-colour, adjacent levels,
    exact 0/1, grey ramp, one channel constant."""
    r = np.random.default_rng(99)
    b = r.random((16, 16, 4), dtype=np.float32)
    b[0] = 0.0
    b[1] = 1.0
    b[2] = r.random((1, 4), dtype=np.float32)
    c = r.random((2, 4), dtype=np.float32)
    b[3] = c[r.integers(0, 2, 16)]
    b[4] = (r.integers(0, 255, (1, 4)) + r.integers(0, 2, (16, 1))) / 255.0
    b[5] = r.integers(0, 2, (16, 4))
    b[6] = (np.arange(16) / 15.0)[:, None]
    b[7, :, 1] = 0.5
    b[8] = c[0] + (np.arange(16) / 15.0)[:, None] * 0.02
    b[..., 3] = 1.0
    return np.clip(b, 0, 1).astype(np.float32)


CASES = {
    "photo51": (lambda: _photo_blocks(51), {}),
    "photo52": (lambda: _photo_blocks(52), {}),
    "hard": (_hard_blocks, {}),
    "four_only": (lambda: _photo_blocks(54), {"allow_three": False}),
    "punch": (lambda: _punch_blocks(False),
              {"use_alpha": True, "alpha_threshold": 0.5}),
    "punch_at_threshold": (lambda: _punch_blocks(True),
                           {"use_alpha": True, "alpha_threshold": 0.5}),
    "adaptive": (lambda: _photo_blocks(51), {"adaptive": True}),
}


@lru_cache(maxsize=None)
def _both(case):
    make, kw = CASES[case]
    b = make()
    jw, je = encode_bc1_blocks_pallas(jnp.asarray(b), tile=8, **kw)
    tw, te = encode_bc1_blocks(torch.from_numpy(b), **kw)
    return (b, kw, np.asarray(jw), np.asarray(je),
            tw.numpy().view(np.uint32), te.numpy(), tw)


def _decoded_error(b, kw, tw):
    dec = decode_bc1(tw, force_four=not kw.get("allow_three", True)).numpy()
    src = b.astype(np.float64) * 255.0
    d = (((src[..., :3] - dec[..., :3]) ** 2) * W).sum(axis=2)
    if kw.get("use_alpha"):
        d = d * (b[..., 3] >= np.float32(kw["alpha_threshold"]))
    return d.sum(axis=1)


@pytest.mark.parametrize("case", [c for c in CASES if c != "adaptive"])
def test_error_is_decode_exact(case):
    b, kw, _, _, _, te, tw = _both(case)
    np.testing.assert_allclose(_decoded_error(b, kw, tw), te,
                               rtol=1e-4, atol=0.5)


@pytest.mark.parametrize("case", list(CASES))
def test_summed_error_matches_pallas_both_ways(case):
    _, _, _, je, _, te, _ = _both(case)
    assert te.sum() <= je.sum() * 1.001 + 1.0
    assert je.sum() <= te.sum() * 1.001 + 1.0


@pytest.mark.parametrize("case", list(CASES))
def test_words_mostly_identical_to_pallas(case):
    _, _, jw, _, tw, _, _ = _both(case)
    assert tw.shape == jw.shape
    assert (tw == jw).all(axis=1).mean() >= 0.9


@pytest.mark.parametrize("case", ["punch", "punch_at_threshold"])
def test_punch_through_alpha_is_bit_exact(case):
    b, kw, jw, _, _, _, tw = _both(case)
    dec = decode_bc1(tw).numpy()
    opaque = b[..., 3] >= np.float32(0.5)
    assert ((dec[..., 3] > 127) == opaque).all()
    # and the transparent pixels sit where the JAX package puts them
    jdec_alpha = (jw[:, 1:2] >> (2 * np.arange(16))[None, :]) & 3
    tdec_alpha = (tw.numpy().view(np.uint32)[:, 1:2]
                  >> (2 * np.arange(16))[None, :]) & 3
    assert ((jdec_alpha == 3) == (tdec_alpha == 3)).all()


def test_adaptive_knob_is_live():
    _, _, _, _, tw_a, _, _ = _both("adaptive")
    _, _, _, _, tw_d, _, _ = _both("photo51")
    assert (tw_a != tw_d).any()


def test_b3d_knob_is_live_and_decode_exact():
    """The joint cube against its own decoder (its JAX graph - 729
    combinations per mode - is left to the JAX package's tests)."""
    b = _photo_blocks(51)
    tw, te = encode_bc1_blocks(torch.from_numpy(b), b3d=True)
    td, ed = encode_bc1_blocks(torch.from_numpy(b))
    assert (tw != td).any()
    np.testing.assert_allclose(_decoded_error(b, {}, tw), te.numpy(),
                               rtol=1e-4, atol=0.5)
    # the cube contains the jitter's start point and scores the same exact
    # palette, so it cannot do much worse in total
    assert te.sum() <= ed.sum() * 1.05


def test_rgb_input_and_missing_alpha_read_as_opaque():
    b = _photo_blocks(52)
    w4, e4 = encode_bc1_blocks(torch.from_numpy(b))
    w3, e3 = encode_bc1_blocks(torch.from_numpy(b[..., :3].copy()))
    assert torch.equal(w4, w3) and torch.equal(e4, e3)
    wa, ea = encode_bc1_blocks(torch.from_numpy(b[..., :3].copy()),
                               use_alpha=True)
    assert torch.equal(wa, w3)


def test_wrapper_takes_plain_version_on_cpu_and_checks_shape():
    b = torch.from_numpy(_photo_blocks(52))
    a = encode_bc1_blocks(b)
    p = encode_bc1_blocks_plain(b)
    assert torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])
    with pytest.raises(ValueError):
        encode_bc1_blocks(torch.zeros(4, 16, 2))
    with pytest.raises(ValueError):
        encode_bc1_blocks(b, weights=(1.0, 1.0))
