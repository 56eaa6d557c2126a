"""The full BC7 search (K5): the port's plain version against the JAX
package's Pallas kernel in interpret mode, the host logic against the JAX
functions, and the plain version on its own at the top tier.

Against JAX, the same numpy blocks go through ``encode_bc7_blocks_pallas`` and
through ``encode_bc7_blocks`` on the CPU, at the configurations the JAX
package's own tests compile (``tests/test_bc7_full_pallas.py``: ``tile=4``,
quality 0.25, the same images and seeds), so one file's compile can serve the
other from the persistent cache. Each configuration is compiled once per
process and its four checks run as consecutive cases. Tolerance, the JAX
package's own bar between its two paths: the reported error equals the error
of the decoded words (``rtol 1e-4, atol 0.5``); the summed error is within
x1.001 + 1.0 both ways; at least 90% of the words are identical (the share is
printed; it is 100% on this host) - XLA on the CPU sums the 16 pixels in
another order than the port's left-to-right chain, which can flip a strict
compare between near-equal candidates; where the words match, so does the
winning mode.

The top tier (quality 1.0) is not compiled for JAX here: its interpret-mode
compile is prohibitive on a CPU. The plain version runs alone there, on 16
blocks, held to its decoder, to the quality-0.25 search, and to the mode 6/7
bar.
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu.kernels import bc7_full as jfull
from gfx_imagecompress_tpu.kernels import bc7_full_pallas as jpallas
from gfx_imagecompress_tpu.pipeline.blocks import image_to_blocks
from gfx_imagecompress_tpu_torch.decode.bc7 import block_modes, decode_bc7
from gfx_imagecompress_tpu_torch.kernels import bc7_full
from gfx_imagecompress_tpu_torch.pipeline.chunking import encode_chunked
from gfx_imagecompress_tpu_torch.tables.bc7_tables import P2

from conftest import photo_rgba

# name -> (mode_mask, image seed, alpha, overrides); as the JAX package's tests
JAX_CASES = {
    "mode0": (0x01, 81, None, {}),
    "mode2": (0x04, 81, None, {}),
    "mode3": (0x08, 81, None, {}),
    "mode4_alpha_ramp": (0x10, 7, "ramp", {}),
    "mode5_alpha": (0x20, 81, 0.6, {}),
    "mode7_alpha": (0x80, 81, 0.6, {}),
    "mode3_shake_uber": (0x08, 3, None, dict(_shake=1, _uber=1)),
    "modes136_top2": (0x4A, 20, None, dict(_plist=tuple(range(8)), _topk=2,
                                           _shake=1, _uber=1)),
}
CHECKS = ("decode_exact", "summed_error", "identical_words", "same_mode")


def _jax_blocks(seed, alpha):
    img = photo_rgba(8, 8, seed=seed)
    if alpha == "ramp":
        img[..., 3] = np.linspace(0.1, 0.9, 8)[None, :]
    elif alpha is not None:
        img[..., 3] = alpha
    return np.array(image_to_blocks(jnp.asarray(img[None])), np.float32)


@lru_cache(maxsize=None)
def _both(name):
    mask, seed, alpha, kw = JAX_CASES[name]
    kw = dict(kw)
    kw.setdefault("_plist", (0, 1))
    kw.setdefault("_topk", 1)
    b = _jax_blocks(seed, alpha)
    wj, ej = jpallas.encode_bc7_blocks_pallas(
        jnp.asarray(b), tile=4, quality=0.25, mode_mask=mask, **kw)
    wt, et = bc7_full.encode_bc7_blocks(torch.from_numpy(b), quality=0.25,
                                        mode_mask=mask, **kw)
    return b, np.array(wj), np.array(ej), wt, et


def _rgba_error(b, words):
    dec = decode_bc7(words).numpy().astype(np.float64)
    return ((b.astype(np.float64) * 255.0 - dec) ** 2).sum(axis=(1, 2))


@pytest.mark.parametrize("name,check", [(n, c) for n in JAX_CASES
                                        for c in CHECKS])
def test_plain_version_against_the_pallas_kernel(name, check):
    b, wj, ej, wt, et = _both(name)
    same = (wt.numpy().view(np.uint32) == wj).all(axis=1)
    if check == "decode_exact":
        np.testing.assert_allclose(et.numpy(), _rgba_error(b, wt),
                                   rtol=1e-4, atol=0.5)
    elif check == "summed_error":
        sj, st = float(ej.sum()), float(et.sum())
        assert st <= sj * 1.001 + 1.0 and sj <= st * 1.001 + 1.0
    elif check == "identical_words":
        print(f"{name}: {same.mean():.4f} of {same.size} blocks identical")
        assert same.mean() >= 0.9
    else:
        modes_j = block_modes(torch.from_numpy(wj.view(np.int32))).numpy()
        modes_t = block_modes(wt).numpy()
        assert (modes_j[same] == modes_t[same]).all()
        assert set(modes_t) <= {m for m in range(8)
                                if (JAX_CASES[name][0] >> m) & 1}


# ------------------------------------------------------------- host logic ---

@pytest.mark.parametrize("quality", [0.0, 0.1, 0.25, 0.3, 0.5, 0.6, 0.75,
                                     0.76, 0.9, 1.0])
def test_budgets_are_the_jax_packages(quality):
    assert bc7_full._budgets(quality) == jpallas._budgets(quality)


def _jax_plan(quality, performance, _topk=None):
    """The JAX entry's performance mapping, read off its source lines."""
    perf = min(max(performance, 0.0), 1.0)
    quality = max(quality, 1.0 - perf) if perf < 1.0 else quality
    nparts, topk, iters, shake, uber = jpallas._budgets(quality)
    if perf < 1.0:
        topk += 1
    if _topk:
        topk = _topk
    return quality, nparts, topk, iters, shake, uber


@pytest.mark.parametrize("performance", [1.0, 0.9, 0.5, 0.3, 0.0, -1.0, 2.0])
@pytest.mark.parametrize("quality", [0.1, 0.25, 0.5, 0.75, 1.0])
def test_performance_mapping_is_the_jax_entrys(quality, performance):
    q, nparts, topk, iters, shake, uber = _jax_plan(quality, performance)
    plan = bc7_full._plan(quality, 0xFF, performance, None, None, None, None)
    assert (plan.iters, plan.shake, plan.uber) == (iters, shake, uber)
    assert plan.keep == (2 if q > 0.75 else 1)
    assert plan.shortlists[1]["k"] == topk == plan.shortlists[2]["k"]
    assert plan.shortlists[7]["plist"] == tuple(range(nparts))
    if q > 0.75:
        assert plan.shortlists[0] == min(nparts, 16)
    else:
        assert plan.shortlists[0]["plist"] == tuple(range(min(nparts, 16)))


def test_largest_shortlist_the_entry_asks_for_is_nine():
    ks = {bc7_full._plan(q, 0xFF, p, None, None, None, None).shortlists[1]["k"]
          for q in (0.1, 0.3, 0.6, 0.8, 1.0) for p in (1.0, 0.9, 0.3, 0.0)}
    assert max(ks) == 9


def _bar_blocks():
    rng = np.random.default_rng(11)
    b = rng.random((48, 16, 4)).astype(np.float32)
    b[:8, :, 3] = 1.0                                        # opaque
    b[8:16] = np.repeat(b[8:16, :1], 16, 1)                  # solid
    b[8:12, :, 3] = 1.0                                      # solid opaque
    b[16:24, :, 3] = rng.integers(0, 2, (8, 16))             # 0/1 alpha
    b[24:28, :, 3] = 0.0
    b[28:32, :5, 3] = 1.0                                    # partial + one 1
    b[32:40, :, 3] = 0.5                                     # partial alpha
    b[40:44, :, 3] = 0.999995                                # near 1
    b[44:48, :, 3] = 0.000005                                # near 0
    return b


@pytest.mark.parametrize("colour,alpha", [(True, True), (True, False),
                                          (False, True), (False, False)])
def test_alpha_bar_is_the_jax_packages(colour, alpha):
    b = _bar_blocks()
    want = np.asarray(jfull._combined_alpha_bar(
        jnp.asarray(b), jnp.asarray(b) * 255.0, colour, alpha))
    got = bc7_full._combined_alpha_bar(torch.from_numpy(b), colour, alpha)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(want) or not (colour or alpha)


# ------------------------------------------------- the plain version alone ---

def _to_blocks(img):
    h, w, c = img.shape
    t = img.reshape(h // 4, 4, w // 4, 4, c).transpose(0, 2, 1, 3, 4)
    return t.reshape(-1, 16, c)


def _mixed16():
    """16 blocks: photo, alpha gradient, solid, 0/1 alpha, two-colour
    splits; every other block opaque."""
    rng = np.random.default_rng(31)
    photo = _to_blocks(photo_rgba(8, 8, seed=32))                    # 4
    grad = _to_blocks(photo_rgba(4, 8, seed=33))                     # 2
    grad[..., 3] = np.linspace(0.05, 0.95, 16)[None, :]
    solid = np.repeat(rng.random((2, 1, 4), np.float32), 16, 1)     # 2
    zo = rng.integers(0, 2, (2, 16, 4)).astype(np.float32)           # 2
    two = []
    for shape in (13, 17, 34, 47, 22, 60):                           # 6
        c = rng.random((2, 4), np.float32)
        pick = [(P2[shape] >> p) & 1 for p in range(16)]
        two.append(np.clip(c[pick] + rng.normal(0, 0.01, (16, 4)), 0, 1))
    x = np.concatenate([photo, grad, solid, zo, np.stack(two)])
    x[::2, :, 3] = 1.0
    assert x.shape == (16, 16, 4)
    return np.ascontiguousarray(x, np.float32)


MASKS = [0xFF] + [1 << m for m in range(8)]


@lru_cache(maxsize=None)
def _plain(quality, mask):
    b = _mixed16()
    w, e = bc7_full.encode_bc7_blocks_plain(torch.from_numpy(b),
                                            quality=quality, mode_mask=mask)
    return b, w, e


@pytest.mark.parametrize("mask", MASKS, ids=lambda m: f"mask{m:#04x}")
def test_top_tier_is_decode_exact(mask):
    b, w, e = _plain(1.0, mask)
    assert torch.isfinite(e).all()
    np.testing.assert_allclose(e.numpy(), _rgba_error(b, w), rtol=1e-4,
                               atol=0.5)
    assert set(block_modes(w).tolist()) <= {m for m in range(8)
                                            if (mask >> m) & 1}


@pytest.mark.parametrize("mask", MASKS, ids=lambda m: f"mask{m:#04x}")
def test_top_tier_is_no_worse_than_the_lowest(mask):
    _, _, e1 = _plain(1.0, mask)
    _, _, e0 = _plain(0.25, mask)
    assert float(e1.sum()) <= float(e0.sum())


def test_barred_blocks_never_take_modes_6_or_7():
    b, w, _ = _plain(1.0, 0xFF)
    bar = bc7_full._combined_alpha_bar(torch.from_numpy(b), True, True)
    assert bar.any() and not bar.all()
    modes = block_modes(w)
    assert not ((modes[bar] == 6) | (modes[bar] == 7)).any()


@pytest.mark.parametrize("quality", [1.0, 0.25])
def test_bar_on_mode_7s_shortlist_changes_no_word(quality):
    """The entry passes the mode 6/7 bar to mode 7's shortlist, which then
    skips the barred blocks; the words and errors are those of ranking every
    block, on blocks that are partly barred."""
    b, w, e = _plain(quality, 0xFF)
    x = torch.from_numpy(b)
    bar = bc7_full._combined_alpha_bar(x, True, True)
    assert bar.any() and not bar.all()
    plan = bc7_full._plan(quality, 0xFF, 1.0, None, None, None, None)

    def every_block(blocks, bar=None, **cfg):
        return bc7_full.estimate_topk_plain(blocks, **cfg)

    w0, e0 = bc7_full._encode(x, plan, bar, every_block,
                              bc7_full.bc7_mode_search_plain)
    assert torch.equal(w, w0)
    np.testing.assert_array_equal(e.numpy(), e0.numpy())


def test_modes_6_7_alone_are_not_barred():
    """With no mode 0-5 enabled nothing masks modes 6/7 (the JAX entry's
    ``maskable``): every block takes one of them."""
    b, w, e = _plain(1.0, 0x40)
    assert (block_modes(w) == 6).all() and (e < 3e38).all()


def test_mode_search_merges_on_strict_improvement():
    b = torch.from_numpy(_mixed16())
    kw = dict(iters=1, shake=0, uber=0)
    w1, e1 = bc7_full.bc7_mode_search(b, 1, 2, **kw)
    w6, e6 = bc7_full.bc7_mode_search(b, 6, None, **kw)
    words, err = w1.clone(), e1.clone()
    bc7_full.bc7_mode_search(b, 6, None, out=(words, err), **kw)
    take = e6 < e1
    assert torch.equal(words, torch.where(take[:, None], w6, w1))
    assert torch.equal(err, torch.where(take, e6, e1))
    # a barred block keeps the running best and is words 0 alone
    bar = torch.ones(16, dtype=torch.bool)
    words, err = w1.clone(), e1.clone()
    bc7_full.bc7_mode_search(b, 6, None, bar=bar, out=(words, err), **kw)
    assert torch.equal(words, w1) and torch.equal(err, e1)
    wb, eb = bc7_full.bc7_mode_search(b, 6, None, bar=bar, **kw)
    assert (wb == 0).all() and (eb == np.float32(3.4e38)).all()


@pytest.mark.parametrize("kw", [
    dict(mode=8), dict(mode=1, ids=None), dict(mode=0, ids=0),
    dict(mode=2, iters=-1), dict(mode=4, keep=3),
    dict(mode=3, bar=torch.zeros(16, dtype=torch.bool)),
], ids=["mode8", "no_ids", "zero_ids", "iters", "keep", "bar_mode3"])
def test_mode_search_rejects_what_it_does_not_take(kw):
    kw = dict(dict(ids=4, iters=1, shake=0, uber=0), **kw)
    with pytest.raises(ValueError):
        bc7_full.bc7_mode_search(torch.zeros((16, 16, 4)), **kw)


@pytest.mark.parametrize("mask", [0, 0x100])
def test_entry_rejects_an_empty_mode_mask(mask):
    with pytest.raises(ValueError):
        bc7_full.encode_bc7_blocks(torch.zeros((2, 16, 4)), mode_mask=mask)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    b = torch.from_numpy(_mixed16()[:6])
    before = dict(bc7_full.LAUNCHES)
    w1, e1 = bc7_full.encode_bc7_blocks(b, quality=0.25)
    w2, e2 = bc7_full.encode_bc7_blocks_plain(b, quality=0.25)
    assert torch.equal(w1, w2) and torch.equal(e1, e2)
    assert bc7_full.LAUNCHES == before


# --------------------------------------------------------------- chunking ---

@pytest.mark.parametrize("chunk", [1, 4, 7, 10, 64])
def test_chunked_encode_equals_one_call(chunk):
    b = torch.from_numpy(_mixed16()[:10])
    calls = []

    def enc(x):
        calls.append(x.shape[0])
        return bc7_full.encode_bc7_blocks(x, quality=0.25, mode_mask=0x4B)

    w, e = encode_chunked(enc, b, chunk=chunk)
    w1, e1 = bc7_full.encode_bc7_blocks(b, quality=0.25, mode_mask=0x4B)
    assert torch.equal(w, w1) and torch.equal(e, e1)
    assert calls == [min(chunk, 10 - i) for i in range(0, 10, chunk)]


def test_chunk_must_be_positive():
    with pytest.raises(ValueError):
        encode_chunked(lambda x: x, torch.zeros((2, 16, 4)), chunk=0)
