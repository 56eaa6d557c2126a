"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and ``nvcc``; they carry the ``cuda`` marker and
skip where there is no device. On a GPU machine run

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: this file needs nothing of tests/conftest.py, which
imports the JAX package's framework). ``chip_smoke.py`` runs the same
comparison at larger sizes.
"""
import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu_torch import kernels
from gfx_imagecompress_tpu_torch.kernels import (bc1, bc4, bc6h, bc7_est,
                                                 bc7_fast, bc7_full)

pytestmark = pytest.mark.cuda


def _blocks(n=2048, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.random((n, 1, 4), np.float32)
    d = rng.normal(0, 0.07, (n, 16, 4)).astype(np.float32)
    b = np.clip(base + d, 0, 1)
    b[:64] = rng.integers(0, 2, (64, 16, 4))        # exact 0/1
    b[64:128] = base[64:128]                        # solid
    return b


CASES = [
    ("bc1", bc1.encode_bc1_blocks, bc1.encode_bc1_blocks_plain, {}),
    ("bc1", bc1.encode_bc1_blocks, bc1.encode_bc1_blocks_plain,
     {"use_alpha": True, "alpha_threshold": 0.5}),
    ("bc1", bc1.encode_bc1_blocks, bc1.encode_bc1_blocks_plain,
     {"allow_three": False, "adaptive": True}),
    ("bc1", bc1.encode_bc1_blocks, bc1.encode_bc1_blocks_plain,
     {"b3d": True}),
    ("bc2", bc1.encode_bc2_blocks, bc1.encode_bc2_blocks_plain,
     {"passes": 2}),
    ("bc3", bc1.encode_bc3_blocks, bc1.encode_bc3_blocks_plain, {}),
    ("bc4", bc4.encode_bc4_blocks, bc4.encode_bc4_blocks_plain, {}),
    ("bc5", bc4.encode_bc5_blocks, bc4.encode_bc5_blocks_plain, {}),
    ("bc7_fast", bc7_fast.encode_bc7_fast_blocks,
     bc7_fast.encode_bc7_fast_blocks_plain, {}),
    ("bc7_fast", bc7_fast.encode_bc7_fast_blocks,
     bc7_fast.encode_bc7_fast_blocks_plain,
     {"fast": True, "perceptual": False}),
]


@pytest.mark.parametrize("name,wrapper,plain,kw", CASES,
                         ids=[f"{c[0]}-{'-'.join(c[3]) or 'default'}"
                              for c in CASES])
def test_kernel_equals_plain_version(name, wrapper, plain, kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_blocks(512 if kw.get("b3d") else 2048)).cuda()
    if name == "bc4":
        x = x[:, :, 0].contiguous()
    if name == "bc7_fast":
        x[::2, :, 3] = 1.0          # mode 1 is for opaque blocks only
    before = kernels.launch_counts()[name]
    wk, ek = wrapper(x, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    wp, ep = plain(x, **kw)
    # same float32 operations in the same order, no contraction: identical
    assert (wk == wp).all(dim=1).double().mean().item() >= 0.99
    torch.testing.assert_close(ek, ep, rtol=1e-5, atol=1e-3)


EST_CASES = {
    "rgb_2sub": dict(chans=3, subsets=2, plist=tuple(range(64)), levels=8,
                     k=4),
    "rgb_3sub": dict(chans=3, subsets=3, plist=tuple(range(16)), levels=4,
                     k=4),
    "rgba_pca": dict(chans=4, subsets=2, plist=tuple(range(64)), levels=4,
                     k=8, estimator="pca"),
    "rgb_2sub_k9": dict(chans=3, subsets=2, plist=tuple(range(64)), levels=8,
                        k=9),
    "rgb_3sub_k16": dict(chans=3, subsets=3, plist=tuple(range(16)),
                         levels=8, k=16),
}


def test_shortlist_launches_are_counted_by_configuration():
    """The full BC7 entry's three shortlists each count one launch under
    their own configuration, and the reset empties the table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_blocks(256)).cuda()
    plan = bc7_full._plan(1.0, 0xFF, 1.0, None, None, None, None)
    cfgs = {bc7_est.config_key(**c): c for c in plan.shortlists.values()
            if isinstance(c, dict)}
    assert len(cfgs) == 3
    kernels.reset_launch_counts()
    for c in cfgs.values():
        bc7_est.estimate_topk(x, **c)
    assert bc7_est.LAUNCHES_BY_CONFIG == {key: 1 for key in cfgs}
    assert kernels.launch_counts()["bc7_est"] == 3
    kernels.reset_launch_counts()
    assert bc7_est.LAUNCHES_BY_CONFIG == {}


@pytest.mark.parametrize("name", list(EST_CASES))
def test_shortlist_kernel_equals_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_blocks(2048)).cuda()
    before = kernels.launch_counts()["bc7_est"]
    ik = bc7_est.estimate_topk(x, **EST_CASES[name])
    torch.cuda.synchronize()
    assert kernels.launch_counts()["bc7_est"] == before + 1
    assert torch.equal(ik, bc7_est.estimate_topk_plain(x, **EST_CASES[name]))


BC1_BUDGETS = {
    "default": {},
    "use_alpha": {"use_alpha": True, "alpha_threshold": 0.5},
    "four_only": {"allow_three": False},
    "b3d": {"b3d": True},
}


@pytest.mark.parametrize("budget", list(BC1_BUDGETS))
@pytest.mark.parametrize("n", [1, 3, 4097])
def test_bc1_kernel_at_block_counts_that_do_not_fill_a_cta(n, budget):
    """K1a encodes 32 blocks per CTA (64 with the 4-colour mode alone), two
    lanes per block and mode: grids whose last CTA is partly empty, words
    and errors bit-identical to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = BC1_BUDGETS[budget]
    if kw.get("b3d") and n > 1000:
        n = 1025
    x = torch.from_numpy(_blocks(max(n, 128), seed=n)[:n].copy()).cuda()
    wk, ek = bc1.encode_bc1_blocks(x, **kw)
    wp, ep = bc1.encode_bc1_blocks_plain(x, **kw)
    assert torch.equal(wk, wp)
    assert torch.equal(ek, ep)


BC23_CASES = {
    "bc3": (bc1.encode_bc3_blocks, bc1.encode_bc3_blocks_plain, {}),
    "bc3_alpha_r1": (bc1.encode_bc3_blocks, bc1.encode_bc3_blocks_plain,
                     {"a_radius": 1, "a_rounds": 1}),
    "bc2": (bc1.encode_bc2_blocks, bc1.encode_bc2_blocks_plain, {}),
    "bc2_adaptive": (bc1.encode_bc2_blocks, bc1.encode_bc2_blocks_plain,
                     {"adaptive": True}),
}


@pytest.mark.parametrize("name", list(BC23_CASES))
@pytest.mark.parametrize("n", [1, 3, 4097])
def test_bc23_kernels_at_block_counts_that_do_not_fill_a_cta(n, name):
    """K1b encodes 32 blocks per CTA (the colour half two lanes per block,
    the alpha families in warps of their own), K1c 128 (one thread per
    block): grids whose last CTA is partly empty, words and errors
    bit-identical to the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wrapper, plain, kw = BC23_CASES[name]
    x = torch.from_numpy(_blocks(max(n, 128), seed=n)[:n].copy()).cuda()
    wk, ek = wrapper(x, **kw)
    wp, ep = plain(x, **kw)
    assert torch.equal(wk, wp)
    assert torch.equal(ek, ep)


BC45_CASES = {
    "bc4": (bc4.encode_bc4_blocks, bc4.encode_bc4_blocks_plain, {}),
    "bc4_r1": (bc4.encode_bc4_blocks, bc4.encode_bc4_blocks_plain,
               {"radius": 1, "rounds": 1}),
    "bc5": (bc4.encode_bc5_blocks, bc4.encode_bc5_blocks_plain, {}),
    "bc5_r1": (bc4.encode_bc5_blocks, bc4.encode_bc5_blocks_plain,
               {"radius": 1, "rounds": 1}),
}


@pytest.mark.parametrize("name", list(BC45_CASES))
@pytest.mark.parametrize("n", [1, 3, 4097])
def test_bc45_kernels_at_block_counts_that_do_not_fill_a_cta(n, name):
    """K2a and K2b encode bc4.BC45_THREADS / (2 * lanes * channels) blocks
    per CTA (a group of lanes per block and channel): grids whose last CTA
    is partly empty, words and errors bit-identical to the plain
    versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wrapper, plain, kw = BC45_CASES[name]
    x = torch.from_numpy(_blocks(max(n, 128), seed=n)[:n].copy()).cuda()
    x = x[:, :, 0].contiguous() if name.startswith("bc4") else \
        x[:, :, :2].contiguous()
    wk, ek = wrapper(x, **kw)
    wp, ep = plain(x, **kw)
    assert torch.equal(wk, wp)
    assert torch.equal(ek, ep)


@pytest.mark.parametrize("barred", [False, True], ids=["free", "barred"])
@pytest.mark.parametrize("n", [1, 3, 4097])
@pytest.mark.parametrize("name", ["rgb_2sub", "rgb_3sub", "rgba_pca"])
def test_shortlist_kernel_at_block_counts_that_do_not_fill_a_cta(name, n,
                                                                 barred):
    """K3 ranks 16 blocks per CTA, 8 lanes per block: grids whose last CTA is
    partly empty, and a bar on every other block (those get the list's first
    k ids); ids equal the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_blocks(max(n, 128), seed=n)[:n].copy()).cuda()
    cfg = EST_CASES[name]
    bar = None
    if barred:
        bar = torch.zeros(n, dtype=torch.bool, device="cuda")
        bar[::2] = True
    ik = bc7_est.estimate_topk(x, **cfg, bar=bar)
    torch.cuda.synchronize()
    assert torch.equal(ik, bc7_est.estimate_topk_plain(x, **cfg, bar=bar))
    if barred:
        first = torch.tensor(cfg["plist"][:cfg["k"]], dtype=torch.int32,
                             device="cuda")
        assert (ik[bar] == first).all()


def test_bc7_wrappers_raise_on_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_blocks(64)).cuda()
    cfg = EST_CASES["rgb_2sub"]
    with pytest.raises(ValueError):
        bc7_est.estimate_topk(x.double(), **cfg)
    with pytest.raises(ValueError):
        bc7_est.estimate_topk(x, **dict(cfg, k=bc7_est.MAX_K + 1))
    with pytest.raises(ValueError):
        bc7_est.estimate_topk(x, **cfg, bar=torch.zeros(64, dtype=torch.bool))
    ids = bc7_est.estimate_topk(x, **cfg)
    with pytest.raises(ValueError):
        bc7_fast.bc7_fast_search(x, ids.long())
    with pytest.raises(ValueError):
        bc7_fast.bc7_fast_search(x, ids.cpu())


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_blocks(64)).cuda()
    with pytest.raises(TypeError):
        bc1.encode_bc1_blocks(x.double())
    with pytest.raises(ValueError):
        bc4.encode_bc4_blocks(x[:, :, 0])             # not contiguous
    with pytest.raises(ValueError):
        bc1.encode_bc3_blocks(x[:, :, :3].contiguous())


FULL_CASES = {
    "q1_all_modes": dict(),
    "q1_performance_0.3": dict(performance=0.3),
    "q05_unrestricted": dict(quality=0.5, colour_restrict=False,
                             alpha_restrict=False),
    "q025_override": dict(quality=0.25, _plist=(0, 1, 5), _topk=2, _shake=1,
                          _uber=1),
    "q025": dict(quality=0.25),
    "q025_top3": dict(quality=0.25, _topk=3),
    **{f"q1_mode{m}": dict(mode_mask=1 << m) for m in range(8)},
}


@pytest.mark.parametrize("name", list(FULL_CASES))
def test_full_bc7_kernel_equals_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_blocks(512)).cuda()
    x[::2, :, 3] = 1.0
    kw = FULL_CASES[name]
    before = kernels.launch_counts()["bc7_full"]
    wk, ek = bc7_full.encode_bc7_blocks(x, **kw)
    torch.cuda.synchronize()
    mask = kw.get("mode_mask", 0xFF)
    assert kernels.launch_counts()["bc7_full"] == before + bin(mask).count("1")
    wp, ep = bc7_full.encode_bc7_blocks_plain(x, **kw)
    assert (wk == wp).all(dim=1).double().mean().item() >= 0.99
    torch.testing.assert_close(ek, ep, rtol=1e-5, atol=1e-3)



@pytest.mark.parametrize("n", [1, 3, 4097])
def test_full_bc7_kernel_at_block_counts_that_do_not_fill_a_cta(n):
    """K5 encodes 8 or 16 blocks per CTA (``bc7_full.LAUNCH_SHAPES``): grids
    whose last CTA is partly empty."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_blocks(max(n, 128), seed=n)[:n].copy()).cuda()
    x[::2, :, 3] = 1.0
    wk, ek = bc7_full.encode_bc7_blocks(x)
    wp, ep = bc7_full.encode_bc7_blocks_plain(x)
    assert torch.equal(wk, wp)
    assert torch.equal(ek, ep)


@pytest.mark.parametrize("first,second", [(1, 5), (0, 7), (4, 2)])
def test_full_bc7_mode_search_merges_into_another_modes_pair(first, second):
    """``out``: one mode's search merged into the running pair of another,
    on strict <, as the plain version merges it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_blocks(1000, seed=11)).cuda()
    x[::3, :, 3] = 1.0
    plan = bc7_full._plan(1.0, 0xFF, 1.0, None, None, None, None)
    bar = bc7_full._combined_alpha_bar(x, True, True)

    def kw(mode):
        cfg = plan.shortlists.get(mode)
        ids = (bc7_est.estimate_topk_plain(x, **cfg) if isinstance(cfg, dict)
               else cfg)
        return dict(ids=ids, iters=plan.iters, shake=plan.shake,
                    uber=plan.uber, keep=plan.keep,
                    bar=bar if mode >= 6 else None)

    w0, e0 = bc7_full.bc7_mode_search_plain(x, first, **kw(first))
    got = (w0.clone(), e0.clone())
    want = (w0.clone(), e0.clone())
    bc7_full.bc7_mode_search(x, second, **kw(second), out=got)
    bc7_full.bc7_mode_search_plain(x, second, **kw(second), out=want)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert not torch.equal(got[0], w0)          # the merge took some blocks

def _hdr_blocks(n=1024, seed=5, signed=False):
    """(n,16,3) float32 HDR blocks: smooth exponent fields with
    multiplicative noise, solid blocks, values at and beyond the half range,
    negatives and half subnormals."""
    rng = np.random.default_rng(seed)
    base = np.exp(rng.uniform(-6, 9, (n, 1, 3)))
    b = base * (1.0 + rng.normal(0, 0.05, (n, 16, 3)))
    b[:32] = base[:32]                                   # solid
    b[32:64] = rng.choice([65504.0, 70000.0, np.inf, 100.0], (32, 16, 3))
    b[64:96] = rng.normal(0, 3.0, (32, 16, 3))
    b[96:128] = rng.random((32, 16, 3)) * 6e-5
    if signed:
        b[128::2, :, 1] *= -1.0
    return b.astype(np.float32)


BC6H_CASES = {
    **{f"q{q}_{s}": dict(quality=q, signed=s == "signed")
       for q in (0.3, 0.7, 0.8, 1.0) for s in ("unsigned", "signed")},
    **{f"q1_mask{m:04x}": dict(mode_mask=m)
       for m in (0x3C00, 0x1FF, 0x200, 0x2000)},
}


@pytest.mark.parametrize("name", list(BC6H_CASES))
def test_bc6h_kernel_equals_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = BC6H_CASES[name]
    x = torch.from_numpy(_hdr_blocks(signed=kw.get("signed", False))).cuda()
    before = kernels.launch_counts()["bc6h"]
    wk, ek = bc6h.encode_bc6h_blocks(x, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["bc6h"] == before + 1
    wp, ep = bc6h.encode_bc6h_blocks_plain(x, **kw)
    assert torch.equal(wk, wp)
    assert torch.equal(ek, ep)


@pytest.mark.parametrize("n", [1, 3, 4097])
@pytest.mark.parametrize("quality", [1.0, 0.3], ids=["q1", "q03"])
def test_bc6h_kernel_at_block_counts_that_do_not_fill_a_cta(quality, n):
    """K6 where the last CTA holds fewer blocks than it has groups: the
    groups past the end return before their first phase and no group waits
    for them. At the top tier (the shake) and at quality 0.3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for signed in (False, True):
        x = torch.from_numpy(_hdr_blocks(4224, signed=signed)[:n]).cuda()
        kw = dict(quality=quality, signed=signed)
        wk, ek = bc6h.encode_bc6h_blocks(x, **kw)
        torch.cuda.synchronize()
        wp, ep = bc6h.encode_bc6h_blocks_plain(x, **kw)
        assert torch.equal(wk, wp)
        assert torch.equal(ek, ep)


@pytest.mark.parametrize("n", [1, 3, 4097])
@pytest.mark.parametrize("budget", ["default", "fast"])
def test_bc7_fast_kernel_at_block_counts_that_do_not_fill_a_cta(budget, n):
    """K4 where the last CTA holds fewer blocks than it has groups, every
    other block opaque (a block with alpha leaves after mode 6): at the
    default budget and the fast one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_blocks(4224)[:n]).cuda()
    x[::2, :, 3] = 1.0
    kw = {"fast": budget == "fast"}
    wk, ek = bc7_fast.encode_bc7_fast_blocks(x, **kw)
    torch.cuda.synchronize()
    wp, ep = bc7_fast.encode_bc7_fast_blocks_plain(x, **kw)
    assert torch.equal(wk, wp)
    assert torch.equal(ek, ep)


def test_bc6h_wrapper_raises_on_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_hdr_blocks(256)).cuda()
    h = bc6h.f32_to_half_int(x, False)
    with pytest.raises(ValueError):
        bc6h.bc6h_search(h.long(), signed=False, topk=2, iters=1, shake=0,
                         mode_mask=0xFFFF)
    with pytest.raises(ValueError):
        bc6h.encode_bc6h_blocks(x, mode_mask=0xC000)
    with pytest.raises(ValueError):
        bc6h.bc6h_search(h, signed=False, topk=33, iters=1, shake=0,
                         mode_mask=0xFFFF)
    # the launcher refuses a fallback mode the mask does not enable
    from gfx_imagecompress_tpu_torch.kernels import _build
    words = torch.empty((256, 4), dtype=torch.int32, device="cuda")
    err = torch.empty((256,), dtype=torch.float32, device="cuda")
    with pytest.raises(RuntimeError):
        _build.launch("bc6h_encode", h, 256, 0, 2, 1, 0, 0x1FF, 12, words,
                      err)


# ----------------------------------------------- block API, sharded encode ---

def _block_api_cases(x):
    from gfx_imagecompress_tpu_torch import blockapi
    w = (0.3086, 0.6094, 0.0820)
    a = x[:, :, 3].contiguous()
    q = torch.round(x * 255.0).to(torch.int64)
    packed = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3]
                                                                 << 24)
    unpacked = q.to(torch.float32)
    unpacked = unpacked / torch.full_like(unpacked, 255.0)
    return {
        "rgb": (lambda: blockapi.compress_rgb_single_mode_blocks(x[..., :3]),
                lambda: bc1.encode_bc1_blocks_plain(
                    x[..., :3], w, 3, 1, allow_three=False)[0], "bc1"),
        "rgb_b3d_r0": (lambda: blockapi.compress_rgb_single_mode_blocks(
            x[:512, :, :3], b3d_refinement=True, refinement_steps=0),
            lambda: bc1.encode_bc1_blocks_plain(
                x[:512, :, :3], w, 2, 1, allow_three=False, b3d=True)[0],
            "bc1"),
        "bc1_punch": (lambda: blockapi.compress_bc1_blocks(
            x, alpha_threshold=0.5), lambda: bc1.encode_bc1_blocks_plain(
                x, w, 3, 1, use_alpha=True, alpha_threshold=0.5)[0], "bc1"),
        "alpha": (lambda: blockapi.compress_alpha_single_mode_blocks(a),
                  lambda: bc4.encode_bc4_blocks_plain(a)[0], "bc4"),
        "explicit_alpha": (lambda: blockapi.compress_explicit_alpha_blocks(a),
                           lambda: blockapi.compress_explicit_alpha_blocks(
                               a.cpu(), device="cpu"), None),
        "multi_mode_q05": (lambda: blockapi.compress_multi_mode_ldr_blocks(
            x[:256], quality=0.5), lambda: bc7_full.encode_bc7_blocks_plain(
                x[:256], quality=0.5)[0], "bc7_full"),
        "bc7enc16": (lambda: blockapi.compress_richgel999_bc7enc16_blocks(
            packed), lambda: bc7_fast.encode_bc7_fast_blocks_plain(
                unpacked)[0], "bc7_fast"),
    }


@pytest.mark.parametrize("name", ["rgb", "rgb_b3d_r0", "bc1_punch", "alpha",
                                  "explicit_alpha", "multi_mode_q05",
                                  "bc7enc16"])
def test_block_api_entry_equals_plain_version_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.from_numpy(_blocks(1024)).cuda()
    entry, plain, kernel = _block_api_cases(x)[name]
    kernels.reset_launch_counts()
    got = entry()
    torch.cuda.synchronize()
    if kernel:
        assert kernels.launch_counts()[kernel] > 0
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), plain().cpu())


def test_sharded_encode_in_an_nccl_world_of_one():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import socket
    import torch.distributed as dist
    from gfx_imagecompress_tpu_torch.dist import sharded
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    assert sharded.init_multihost(coordinator_address=f"127.0.0.1:{port}",
                                  num_processes=1, process_id=0,
                                  backend="nccl")
    try:
        x = torch.from_numpy(_blocks(4097)).cuda()
        for fn in (bc1.encode_bc1_blocks, bc7_fast.encode_bc7_fast_blocks):
            words, err, mse = sharded.shard_encode(fn, x)
            want_w, want_e = fn(x)
            assert torch.equal(words, want_w) and torch.equal(err, want_e)
            expect = want_e.double().sum().item() / (4097 * 16)
            assert abs(mse - expect) <= 1e-6 * abs(expect)
    finally:
        dist.destroy_process_group()
