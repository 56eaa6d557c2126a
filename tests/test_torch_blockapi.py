"""The port's batched block API (``blockapi.py``) against the JAX package's.

The same seeded blocks go through each JAX entry (the XLA functions, on the
CPU) and through the port's entry with ``device="cpu"`` (the plain versions
of the kernels the card runs), at the JAX tests' block shapes
(``tests/test_blockapi.py``), so one file's compile serves the other from the
persistent cache. The bar is the one the JAX package sets between its own
two routes (``tests/test_bc1_pallas.py``):
  - the summed decoded error within x1.001 + 1.0 of the JAX entry's, both
    ways;
  - at least 90% of the blocks' words identical; every word for the BC4
    and the explicit-alpha entries.

With ``b3d_refinement`` the colour entries are held here to their mapping
(the flag goes to the search as ``b3d``, with one refinement pass) and to
the decoder; ``tests/test_torch_blockapi_b3d.py`` holds them to the JAX
entries, run eagerly (the jitted joint cube does not compile within a
test's time on a CPU).

The two BC7 entries are in ``tests/test_torch_blockapi_bc7.py`` (their JAX
traces take most of a minute).
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu import blockapi as jblockapi
from gfx_imagecompress_tpu.pipeline.blocks import image_to_blocks
from gfx_imagecompress_tpu_torch import blockapi
from gfx_imagecompress_tpu_torch.decode import bcn
from gfx_imagecompress_tpu_torch.kernels import bc1
from gfx_imagecompress_tpu_torch.options import PERCEPTUAL_WEIGHTS

from conftest import photo_rgba


def _photo(seed, alpha=None):
    img = photo_rgba(8, 8, seed=seed)
    if alpha is not None:
        img[..., 3] = alpha
    return np.array(image_to_blocks(jnp.asarray(img[None])), np.float32)


def _alpha():
    return np.random.default_rng(42).random((8, 16), dtype=np.float32)


def _mixed_alpha():
    """Punch-through blocks: alpha 0.25 or 1.0, a threshold of 0.5 between."""
    img = photo_rgba(8, 8, seed=42)
    img[::3, ::2, 3] = 0.25
    return np.array(image_to_blocks(jnp.asarray(img[None])), np.float32)


def _rgb_err(dec, src01, nch=3):
    return float(((dec[..., :nch].astype(np.float64)
                   - np.rint(src01[..., :nch].astype(np.float64) * 255))
                  ** 2).sum())


# name -> (JAX call, port call, decode to (N,16,C) uint8, error of a decode,
#          every word must match)
CASES = {
    "rgb_r0": (lambda: jblockapi.compress_rgb_single_mode_blocks(
        _photo(41)[..., :3], refinement_steps=0),
        lambda: blockapi.compress_rgb_single_mode_blocks(
            _photo(41)[..., :3], refinement_steps=0, device="cpu"),
        lambda w: bcn.decode_bc1(w, force_four=True),
        lambda d: _rgb_err(d, _photo(41)), False),
    "rgb_r1": (lambda: jblockapi.compress_rgb_single_mode_blocks(
        _photo(41)[..., :3]),
        lambda: blockapi.compress_rgb_single_mode_blocks(
            _photo(41)[..., :3], device="cpu"),
        lambda w: bcn.decode_bc1(w, force_four=True),
        lambda d: _rgb_err(d, _photo(41)), False),
    "bc1_r0": (lambda: jblockapi.compress_bc1_blocks(
        _photo(42), refinement_steps=0),
        lambda: blockapi.compress_bc1_blocks(_photo(42), refinement_steps=0,
                                             device="cpu"),
        bcn.decode_bc1, lambda d: _rgb_err(d, _photo(42)), False),
    "bc1_r1_threshold": (lambda: jblockapi.compress_bc1_blocks(
        _mixed_alpha(), alpha_threshold=0.5),
        lambda: blockapi.compress_bc1_blocks(_mixed_alpha(),
                                             alpha_threshold=0.5,
                                             device="cpu"),
        bcn.decode_bc1, lambda d: _rgb_err(d, _mixed_alpha(), 4), False),
    "alpha": (lambda: jblockapi.compress_alpha_single_mode_blocks(_alpha()),
              lambda: blockapi.compress_alpha_single_mode_blocks(
                  _alpha(), device="cpu"),
              lambda w: bcn.decode_bc4(w)[:, :, :1],
              lambda d: _rgb_err(d, _alpha()[..., None], 1), True),
    "explicit_alpha": (lambda: jblockapi.compress_explicit_alpha_blocks(
        _alpha()), lambda: blockapi.compress_explicit_alpha_blocks(
            _alpha(), device="cpu"),
        lambda w: bcn.decode_bc2_alpha(w)[..., None],
        lambda d: _rgb_err(d, _alpha()[..., None], 1), True),
}


@lru_cache(maxsize=None)
def _both(name):
    jfn, tfn, decode, err, _ = CASES[name]
    wj = np.array(jfn())
    wt = tfn()
    assert wt.dtype == torch.int32 and wt.device.type == "cpu"
    wj_t = torch.from_numpy(wj.view(np.int32))
    ej = err(decode(wj_t).numpy())
    et = err(decode(wt).numpy())
    return wj, wt.numpy().view(np.uint32), ej, et


@pytest.mark.parametrize("name", list(CASES))
def test_summed_error_matches_jax_both_ways(name):
    _, _, ej, et = _both(name)
    assert et <= ej * 1.001 + 1.0, (et, ej)
    assert ej <= et * 1.001 + 1.0, (et, ej)


@pytest.mark.parametrize("name", list(CASES))
def test_words_identical_to_jax(name):
    wj, wt, _, _ = _both(name)
    assert wt.shape == wj.shape
    same = (wj == wt).all(axis=1).mean()
    assert same == 1.0 if CASES[name][4] else same >= 0.9, same


def test_bc1_threshold_makes_transparent_blocks():
    words = blockapi.compress_bc1_blocks(_mixed_alpha(), alpha_threshold=0.5,
                                         device="cpu")
    dec = bcn.decode_bc1(words).numpy()
    src = _mixed_alpha()
    np.testing.assert_array_equal(dec[..., 3] == 0, src[..., 3] < 0.5)


@pytest.mark.parametrize("entry", ["rgb", "bc1"])
@pytest.mark.parametrize("steps", [0, 1])
def test_colour_entries_map_b3d_refinement_to_the_cube(entry, steps,
                                                       monkeypatch):
    """``b3d_refinement`` goes to the search as ``b3d`` with one pass and
    ``iters = 2 + refinement_steps``; the words are the wrapper's and they
    differ from the entry's without it."""
    b = _photo(51)
    x = b[..., :3] if entry == "rgb" else b
    fn = (blockapi.compress_rgb_single_mode_blocks if entry == "rgb"
          else blockapi.compress_bc1_blocks)
    seen = []
    real = bc1.encode_bc1_blocks

    def spy(blocks, **kw):
        seen.append(kw)
        return real(blocks, **kw)

    monkeypatch.setattr(bc1, "encode_bc1_blocks", spy)
    w3d = fn(x, b3d_refinement=True, refinement_steps=steps,
             adaptive_colour_weights=True, device="cpu")
    assert seen == [dict(weights=PERCEPTUAL_WEIGHTS, iters=2 + steps,
                         passes=1, b3d=True,
                         allow_three=entry == "bc1",
                         **({} if entry == "rgb" else
                            dict(use_alpha=False, alpha_threshold=0.0)))]
    want, _ = real(torch.from_numpy(x), weights=PERCEPTUAL_WEIGHTS,
                   iters=2 + steps, passes=1, b3d=True,
                   allow_three=entry == "bc1")
    assert torch.equal(w3d, want)
    plain = fn(x, refinement_steps=steps, device="cpu")
    assert not torch.equal(w3d, plain)
    dec = bcn.decode_bc1(w3d, force_four=entry == "rgb").numpy()
    src = np.rint(x[..., :3].astype(np.float64) * 255)
    assert np.abs(dec[..., :3] - src).mean() < 8


def test_entries_take_tensors_and_refuse_what_they_cannot_take():
    b = _photo(41)
    t = blockapi.compress_bc1_blocks(torch.from_numpy(b), device="cpu")
    assert torch.equal(t, blockapi.compress_bc1_blocks(b, device="cpu"))
    with pytest.raises(ValueError, match="16"):
        blockapi.compress_alpha_single_mode_blocks(np.zeros((2, 15)),
                                                   device="cpu")


def test_device_none_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="cuda"):
        blockapi.compress_explicit_alpha_blocks(_alpha())
