"""The seeded mixes are reproducible and sized as stated."""
import numpy as np
import pytest
import torch

from benchmark import record, spec, textures
from benchmark.loops import serve
from benchmark.record import sample_index


def test_bake_sets_are_sized_as_stated():
    for name, alphas in (("bake_opaque", {"opaque"}),
                         ("bake_alpha", {"soft", "cutout"})):
        mix = spec.load_mix(name)
        sizes = sorted(s for e in mix["textures"]
                       for s in [e["size"]] * e["count"])
        assert sizes == [1024] * 2 + [2048] * 4 + [4096] * 2
        assert {e["alpha"] for e in mix["textures"]} == alphas
        assert mix["in_flight"] == 2
        if name == "bake_alpha":        # half soft, half cutout at each size
            for size in (1024, 2048, 4096):
                kinds = [e["alpha"] for e in mix["textures"]
                         for _ in range(e["count"]) if e["size"] == size]
                assert sorted(kinds).count("soft") == len(kinds) // 2
    assert len(textures.chain_sizes(4096)) == 13
    assert textures.chain_sizes(4096)[-3:] == [4, 2, 1]


@pytest.mark.parametrize("name", ["serve_opaque", "serve_alpha"])
def test_serve_schedule_is_seeded_and_holds_the_mix(name):
    mix = spec.load_mix(name)
    a = serve.schedule(mix, 2**31 + 5, 20.0)
    b = serve.schedule(mix, 2**31 + 5, 20.0)
    c = serve.schedule(mix, 2**31 + 6, 20.0)
    assert a == b and a != c
    m = sum(mix["frame"])
    assert mix["frame"] == [6, 5, 4, 3, 2]      # 0.30/0.25/0.20/0.15/0.10
    assert mix["sizes"] == [256, 512, 1024, 2048, 4096]
    for f in range(len(a) // m):
        kinds = [k for _, k, _ in a[f * m:(f + 1) * m]]
        assert np.bincount(kinds, minlength=5).tolist() == mix["frame"]
    due = [d for d, _, _ in a]
    assert due == sorted(due) and due[-1] < 20.0
    assert len(a) == pytest.approx(mix["rate_per_s"] * 20.0, rel=0.01)
    # every seed offers the same gaps, in another order
    gaps = lambda s: sorted(np.round(np.diff([0.0] + [d for d, _, _ in s]),
                                     9)[:m])
    assert gaps(a) == gaps(c)
    # the requests of one size take its pool textures in turn
    per = mix["pool_per_size"]
    assert per == 10
    for k in range(len(mix["sizes"])):
        js = [j for _, kk, j in a if kk == k]
        assert js == [i % per for i in range(len(js))]


def test_textures_are_seeded_and_their_alpha_is_as_stated():
    dev = "cpu"
    for kind in textures.ALPHA_KINDS:
        x = textures.to_u8(textures.texture(textures.generator(11, dev), 256,
                                            kind, dev))
        y = textures.to_u8(textures.texture(textures.generator(11, dev), 256,
                                            kind, dev))
        z = textures.to_u8(textures.texture(textures.generator(12, dev), 256,
                                            kind, dev))
        assert torch.equal(x, y) and not torch.equal(x, z)
        a = x[..., 3]
        if kind == "opaque":
            assert bool((a == 255).all())
        elif kind == "soft":
            assert int(a.max()) <= round(255 * textures.SOFT_ALPHA_MAX)
        else:
            share = (a == 255).double().mean().item()
            assert 0.30 < share < 0.45
            edge = ((a > 0) & (a < 255)).double().mean().item()
            assert 0.0 < edge < 0.15


def test_mip_chain_and_layout():
    base = textures.texture(textures.generator(3, "cpu"), 16, "cutout", "cpu")
    levels = textures.mip_chain(base)
    assert [lv.shape[0] for lv in levels] == [16, 8, 4, 2, 1]
    b = textures.to_blocks(levels[3])                  # 2x2: one padded block
    assert b.shape == (1, 16, 4)
    assert torch.equal(b[0, 15], levels[3][1, 1])      # clamped to the edge
    x = torch.arange(10 * 7 * 3).reshape(10, 7, 3)
    assert torch.equal(textures.from_blocks(textures.to_blocks(x), 10, 7), x)


def test_sample_index_is_seeded_and_holds_the_last_block():
    assert record.CHECK_BLOCKS_PER_CALL == 2
    a = sample_index(2**31 + 1, 5, 1000)
    assert np.array_equal(a, sample_index(2**31 + 1, 5, 1000))
    assert 999 in a and len(a) in (2, 3) and a.max() < 1000
    assert sample_index(7, 0, 1).tolist() == [0]


def test_the_comparison_and_psnr_are_set_by_the_harness_not_the_mix():
    for name in ("bake_opaque", "bake_alpha", "serve_opaque", "serve_alpha"):
        mix = spec.load_mix(name)
        assert not {"check_blocks_per_call", "psnr_requests", "psnr_channels",
                    "drain_s"} & set(mix)
        alphas = (mix["alpha"] if mix["loop"] == "serve"
                  else [e["alpha"] for e in mix["textures"]])
        assert record.psnr_channels(alphas) == (3 if "opaque" in name else 4)
    assert (serve.PSNR_REQUESTS, serve.DRAIN_S) == (200, 60.0)
