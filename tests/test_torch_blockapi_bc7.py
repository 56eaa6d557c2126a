"""The port's two BC7 block entries (``blockapi.py``) against the JAX
package's: ``compress_multi_mode_ldr_blocks`` (the full search) and
``compress_richgel999_bc7enc16_blocks`` (the fast one, from packed RGBA8
words). ``tests/test_torch_blockapi.py`` holds the colour and alpha entries.

The same seeded blocks go through the JAX entry (its XLA function, on the
CPU) and the port's with ``device="cpu"`` (the plain versions), at the block
shapes of ``tests/test_blockapi.py``. The bar is the JAX package's between
its two routes (``tests/test_bc1_pallas.py``): the summed decoded error
within x1.001 + 1.0 both ways, and at least 90% of the words identical.

The multi-mode entry runs at quality 0.25 against JAX (the top tier's XLA
compile takes minutes); at the default it is held to pass its options to
``encode_bc7_blocks``, whose card run ``chip_smoke.py`` holds to the plain
version. Its words are not held to the JAX entry's: the entry's XLA route
and the Pallas kernel, which the port's kernels mirror, choose different
mode-4 encodings for some blocks at quality 0.25 (on 8 photos of 4 blocks,
seeds 80-87, mode 4 alone: 24 of 32 blocks alike), with errors on either
side. The port's words equal the Pallas kernel's there
(``tests/test_torch_bc7_full.py``, ``mode4_alpha_ramp``); here the entry is
held to ``encode_bc7_blocks`` and to the summed-error bar against the JAX
entry.
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu import blockapi as jblockapi
from gfx_imagecompress_tpu.pipeline.blocks import image_to_blocks
from gfx_imagecompress_tpu_torch import blockapi
from gfx_imagecompress_tpu_torch.decode.bc7 import decode_bc7
from gfx_imagecompress_tpu_torch.kernels import bc7_full

from conftest import photo_rgba


def _photo(seed):
    img = photo_rgba(8, 8, seed=seed)
    return np.array(image_to_blocks(jnp.asarray(img[None])), np.float32)


def _packed():
    img = (photo_rgba(8, 8, seed=43) * 255).astype(np.uint32)
    packed = (img[..., 0] | (img[..., 1] << 8) | (img[..., 2] << 16)
              | (img[..., 3] << 24))
    return np.array(image_to_blocks(jnp.asarray(packed[None, :, :, None]))
                    )[:, :, 0]


def _unpacked(packed):
    return np.stack([(packed >> s) & 0xFF for s in (0, 8, 16, 24)],
                    axis=-1).astype(np.float64)


def _err(dec, src255):
    return float(((dec.astype(np.float64) - src255) ** 2).sum())


@lru_cache(maxsize=None)
def _multi_mode():
    b = _photo(81)
    wj = np.array(jblockapi.compress_multi_mode_ldr_blocks(b, quality=0.25))
    wt = blockapi.compress_multi_mode_ldr_blocks(b, quality=0.25,
                                                 device="cpu")
    return b, wj, wt


@lru_cache(maxsize=None)
def _bc7enc16():
    p = _packed()
    wj = np.array(jblockapi.compress_richgel999_bc7enc16_blocks(p))
    wt = blockapi.compress_richgel999_bc7enc16_blocks(p, device="cpu")
    return p, wj, wt


def _errors(src255, wj, wt):
    ej = _err(decode_bc7(torch.from_numpy(wj.view(np.int32))).numpy(), src255)
    et = _err(decode_bc7(wt).numpy(), src255)
    return ej, et


@pytest.mark.parametrize("entry", ["multi_mode_q025", "bc7enc16"])
def test_summed_error_matches_jax_both_ways(entry):
    if entry == "bc7enc16":
        p, wj, wt = _bc7enc16()
        src = _unpacked(p)
    else:
        b, wj, wt = _multi_mode()
        src = np.rint(b.astype(np.float64) * 255)
    assert wt.dtype == torch.int32 and tuple(wt.shape) == wj.shape
    ej, et = _errors(src, wj, wt)
    assert et <= ej * 1.001 + 1.0, (et, ej)
    assert ej <= et * 1.001 + 1.0, (et, ej)


def test_bc7enc16_words_identical_to_jax():
    _, wj, wt = _bc7enc16()
    same = (wj == wt.numpy().view(np.uint32)).all(axis=1).mean()
    assert same >= 0.9, same


def test_bc7enc16_entry_takes_the_int32_storage_of_its_words():
    packed = _packed()
    b = blockapi.compress_richgel999_bc7enc16_blocks(
        torch.from_numpy(packed.astype(np.uint32).view(np.int32)),
        device="cpu")
    assert torch.equal(_bc7enc16()[2], b)


def test_multi_mode_entry_at_quality_025_is_encode_bc7_blocks():
    b, _, wt = _multi_mode()
    want, _ = bc7_full.encode_bc7_blocks(torch.from_numpy(b), quality=0.25)
    assert torch.equal(wt, want)


def test_multi_mode_entry_passes_its_options_to_encode_bc7_blocks(
        monkeypatch):
    """At the default, the entry is ``encode_bc7_blocks`` with the entry's
    options (``src_has_alpha`` unused)."""
    seen = []

    def stub(blocks, **kw):
        seen.append((blocks, kw))
        return torch.arange(blocks.shape[0] * 4, dtype=torch.int32).reshape(
            -1, 4), None

    monkeypatch.setattr(bc7_full, "encode_bc7_blocks", stub)
    b = _photo(82)
    words = blockapi.compress_multi_mode_ldr_blocks(b, src_has_alpha=False,
                                                    device="cpu")
    (blocks, kw), = seen
    assert torch.equal(blocks, torch.from_numpy(b))
    assert kw == dict(quality=1.0, mode_mask=0xFF, colour_restrict=True,
                      alpha_restrict=True, performance=1.0)
    assert torch.equal(words, torch.arange(16, dtype=torch.int32).reshape(
        4, 4))
