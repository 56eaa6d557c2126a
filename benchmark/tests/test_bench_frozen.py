"""The frozen copies under ``benchmark/`` equal the program's code as it
stood when they were copied: the roofline counts at both configurations'
budgets, the BC7 decoder, and the plain encoders the reference runs."""
import json

import pytest
import torch

from benchmark import check, counts, spec
from benchmark.encoders import bc7_fast as enc_fast
from benchmark.encoders import bc7_full as enc_full
from benchmark.reference import decode_bc7 as frozen_decode
from benchmark.reference import fast as frozen_fast
from benchmark.reference import full as frozen_full
from gfx_imagecompress_tpu_torch import roofline
from gfx_imagecompress_tpu_torch.decode.bc7 import decode_bc7
from gfx_imagecompress_tpu_torch.kernels import bc7_fast, bc7_full


def config(name):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("unbarred", [0.0, 0.37, 1.0])
def test_counts_equal_roofline_at_the_full_budget(unbarred):
    assert counts.PEAK_F32_OPS_PER_S == roofline.PEAK_F32_OPS_PER_S
    assert counts.PEAK_BYTES_PER_S == roofline.PEAK_BYTES_PER_S
    assert counts.ops_bc7_full(unbarred) == roofline.ops_bc7_full(unbarred)
    assert counts.bytes_bc7_full(unbarred) == roofline.bytes_bc7_full(
        unbarred)
    for m in range(8):
        assert counts.ops_bc7_full_mode(m) == roofline.ops_bc7_full_mode(m)
    for kw in (dict(chans=3, subsets=2, nparts=64, k=8),
               dict(chans=3, subsets=3, nparts=64, k=8),
               dict(chans=4, subsets=2, nparts=64, k=8, pca=True)):
        assert counts.ops_bc7_est(**kw) == roofline.ops_bc7_est(**kw)
    # the per-launch split adds up to the program's per-block counts
    opts = enc_full.options(config("bc7_amd_q1"))
    n = 65536
    u = round(unbarred * n)
    b = enc_full.bounds({"slabs": [(n, u)]}, opts)
    k5_ops = roofline.ops_bc7_full(u / n) * n
    assert b["k5"] == pytest.approx(k5_ops / roofline.PEAK_F32_OPS_PER_S,
                                    rel=2e-3)


@pytest.mark.parametrize("opaque", [0.0, 0.5, 1.0])
def test_counts_equal_roofline_at_the_fast_budget(opaque):
    opts = enc_fast.options(config("bc7enc16_default"))
    plist, topk, uber = bc7_fast._budget(opts["fast"], None, None, None)
    assert (counts.ops_bc7_fast(perceptual=True, uber=uber, k=topk,
                                opaque_frac=opaque)
            == roofline.ops_bc7_fast(perceptual=True, uber=uber, k=topk,
                                     opaque_frac=opaque))
    n = 4096
    b = enc_fast.bounds({"blocks": n, "opaque": round(opaque * n)}, opts)
    assert b["k3"] == pytest.approx(
        roofline.ops_bc7_est(nparts=len(plist), k=topk) * n
        / roofline.PEAK_F32_OPS_PER_S)
    assert b["k4"] == pytest.approx(
        roofline.ops_bc7_fast(uber=uber, k=topk, opaque_frac=opaque) * n
        / roofline.PEAK_F32_OPS_PER_S)


def test_decoder_copy_equals_the_program_decoder_on_random_words():
    g = torch.Generator().manual_seed(0)
    w = torch.randint(-2**31, 2**31 - 1, (4096, 4), generator=g,
                      dtype=torch.int64).to(torch.int32)
    w[:, 0] = (w[:, 0] & ~0xFF) | (1 << torch.randint(
        0, 9, (4096,), generator=g)).to(torch.int32) & 0xFF  # every mode
    assert torch.equal(frozen_decode.decode_bc7(w), decode_bc7(w))
    assert torch.equal(check.decode(w), decode_bc7(w))


def _blocks(n, alpha, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 16, 4), generator=g)
    x[: n // 4] = x[: n // 4, :1]                  # solid blocks
    if not alpha:
        x[..., 3] = 1.0
    else:
        x[n // 2:, :, 3] = (x[n // 2:, :, 3] > 0.5).float()   # 0/1 alpha
    return (x * 255).round() / 255


@pytest.mark.parametrize("alpha", [False, True])
def test_fast_reference_equals_the_program_plain_version(alpha):
    x = _blocks(64, alpha, 1)
    for opts in ({"fast": False, "perceptual": True},
                 {"fast": True, "perceptual": True}):
        assert torch.equal(frozen_fast.encode_bc7_fast_blocks_plain(x, **opts)[0],
                           bc7_fast.encode_bc7_fast_blocks_plain(x, **opts)[0])


def test_full_reference_equals_the_program_plain_version():
    x = torch.cat([_blocks(6, False, 2), _blocks(6, True, 3)])
    opts = enc_full.options(config("bc7_amd_q1"))
    assert torch.equal(frozen_full.encode_bc7_blocks_plain(x, **opts)[0],
                       bc7_full.encode_bc7_blocks_plain(x, **opts)[0])
