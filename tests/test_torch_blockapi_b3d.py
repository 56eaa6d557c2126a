"""The port's colour block entries with ``b3d_refinement`` against the JAX
package's.

With ``b3d_refinement`` the JAX entries run the joint 3-channel cube
(``refine3d_565``: 729 candidate moves, each a few array operations). Traced
under ``jit`` that graph does not compile within a test's time on a CPU, so
the JAX entry runs eagerly here (``jax.disable_jit()``), one operation at a
time, on 16-block photos: about 35 s for the six cases with one worker.
The bars are those of ``tests/test_torch_blockapi.py``: the summed decoded
error within x1.001 + 1.0 of the JAX entry's, both ways, and at least 90% of
the blocks' words identical.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu import blockapi as jblockapi
from gfx_imagecompress_tpu.pipeline.blocks import image_to_blocks
from gfx_imagecompress_tpu_torch import blockapi
from gfx_imagecompress_tpu_torch.decode import bcn

from conftest import photo_rgba
from test_torch_blockapi import _rgb_err


def _photo(seed, punch=False):
    img = photo_rgba(16, 16, seed=seed)
    if punch:
        img[::3, ::2, 3] = 0.25
    return np.array(image_to_blocks(jnp.asarray(img[None])), np.float32)


# name -> (entry, blocks, keyword arguments, decode's force_four)
CASES = {
    "rgb": ("compress_rgb_single_mode_blocks", lambda: _photo(41)[..., :3],
            {}, True),
    "bc1": ("compress_bc1_blocks", lambda: _photo(42), {}, False),
    "bc1_threshold": ("compress_bc1_blocks", lambda: _photo(43, punch=True),
                      dict(alpha_threshold=0.5), False),
}
PARAMS = [(name, steps) for name in CASES for steps in (0, 1)]
IDS = [f"{name}_r{steps}" for name, steps in PARAMS]


@lru_cache(maxsize=None)
def _both(name, steps):
    entry, blocks, kw, force_four = CASES[name]
    x = blocks()
    with jax.disable_jit():
        wj = np.array(getattr(jblockapi, entry)(
            x, b3d_refinement=True, refinement_steps=steps, **kw))
    wt = getattr(blockapi, entry)(x, b3d_refinement=True,
                                  refinement_steps=steps, device="cpu", **kw)
    assert wt.dtype == torch.int32 and wt.device.type == "cpu"
    nch = 4 if kw else 3

    def err(w):
        dec = bcn.decode_bc1(w, force_four=force_four).numpy()
        return _rgb_err(dec, x, nch)

    return (wj, wt.numpy().view(np.uint32),
            err(torch.from_numpy(wj.view(np.int32))), err(wt))


@pytest.mark.parametrize("name,steps", PARAMS, ids=IDS)
def test_summed_error_matches_jax_both_ways(name, steps):
    _, _, ej, et = _both(name, steps)
    assert et <= ej * 1.001 + 1.0, (et, ej)
    assert ej <= et * 1.001 + 1.0, (et, ej)


@pytest.mark.parametrize("name,steps", PARAMS, ids=IDS)
def test_words_identical_to_jax(name, steps):
    wj, wt, _, _ = _both(name, steps)
    assert wt.shape == wj.shape
    assert (wj == wt).all(axis=1).mean() >= 0.9
