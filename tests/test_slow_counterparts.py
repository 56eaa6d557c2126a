"""Default-run tests of the properties of the suite's `slow` tests.

The root conftest marks `slow` two JAX-package tests that overrun the
per-test limit in their Pallas interpret compiles. Each property is held
here by a test that runs in seconds to a minute and a half.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from gfx_imagecompress_tpu.bench_quality import run
from test_quality_gate import CHEAP, TOL_DB


# The bc7_fast row, left out, compiles K4 at its whole default budget
# (64 partitions, uber 4) in interpret mode: more than 11 minutes alone.
@pytest.mark.parametrize("row", [r for r in CHEAP if r != "bc7_fast"])
def test_quality_gate_pallas_row(row):
    """test_quality_gate.py::test_quality_gate_cheap_rows_pallas's gate,
    one row a case: the shipping path's Pallas kernels (interpret mode on
    the CPU) at full budgets, fw PSNR >= the reference algorithm's."""
    (r,) = run(only=[row], pallas=True)
    assert r["config"] == row and r["path"] == "pallas"
    assert r["delta_db"] >= TOL_DB, (
        f"{row} (pallas): fw {r['fw_psnr']} vs ref {r['ref_psnr']} "
        f"(delta {r['delta_db']} dB)")


@pytest.mark.eager
def test_bc6h_options_quality_reaches_the_encoder(monkeypatch):
    """test_options.py::test_bc6h_options_quality_reaches_encoder with the
    XLA-path BC6H encoder standing in for the Pallas kernel, at the same
    static budgets: compress_amd_bc6h hands BC6HOptions' quality and mode
    mask to the encoder, and quality 1.0 and 0.3 give other blocks."""
    from gfx_imagecompress_tpu.api import compress_amd_bc6h
    from gfx_imagecompress_tpu.image import Image
    from gfx_imagecompress_tpu.kernels import bc6h, bc6h_pallas
    from gfx_imagecompress_tpu.options import BC6HOptions
    for q in (1.0, 0.3):
        assert bc6h_pallas._budgets(q) == bc6h._budgets(q)
    seen = []

    def entry(blocks, *, signed, mode_mask, quality):
        seen.append((quality, mode_mask, signed, blocks.shape))
        return bc6h.encode_bc6h_blocks(blocks, signed=signed,
                                       mode_mask=mode_mask, quality=quality)

    monkeypatch.setattr(bc6h_pallas, "encode_bc6h_blocks_pallas", entry)
    rng = np.random.default_rng(5)
    img = np.exp(rng.random((16, 16, 3), np.float32) * 3.0)
    src = Image(data=jnp.asarray(img[None]), hdr=True)
    hi = compress_amd_bc6h(src, options=BC6HOptions(quality=1.0))
    lo = compress_amd_bc6h(src, options=BC6HOptions(quality=0.3))
    assert seen == [(1.0, 0xFFFF, False, (16, 16, 3)),
                    (0.3, 0xFFFF, False, (16, 16, 3))]
    assert not np.array_equal(np.asarray(hi.blocks), np.asarray(lo.blocks))
