"""The port's quality matrix (``bench_quality.py``) and its copy of the
reference-faithful CPU encoders (``refcpu/``).

- each ``refcpu`` file differs from the JAX package's twin only in its import
  lines, and each encoder gives the JAX package's words on a few blocks at
  its cheapest budget;
- the corpus, the matrix and the cache keys are the JAX package's, and every
  key of the full matrix is in the port's cache;
- the quality gate of the JAX package's test (``tests/test_quality_gate.py``:
  port PSNR >= reference PSNR - 0.05 dB) on its seven cheap rows, through the
  plain versions on the CPU, with the reference side from the cache.
"""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gfx_imagecompress_tpu import bench_quality as jbq
from gfx_imagecompress_tpu.refcpu import (bc6h_amd as jbc6h, bc7_amd as jbc7,
                                          bc7enc16 as jenc16, bcx_amd as jbcx)
from gfx_imagecompress_tpu_torch import bench_quality as bq
from gfx_imagecompress_tpu_torch.refcpu import (bc6h_amd, bc7_amd, bc7enc16,
                                                bcx_amd)

ROOT = Path(__file__).resolve().parent.parent
CHEAP = ["bc1", "bc1_punch", "bc4", "bc2", "bc3", "bc7_fast", "bc7_fastest"]
FILES = ["__init__.py", "corpus.py", "bcx_amd.py", "bc7enc16.py",
         "bc7_amd.py", "bc6h_amd.py"]


def _without_imports(text):
    """The source with its import statements' lines taken out."""
    lines = text.splitlines()
    drop = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno - 1, node.end_lineno))
    return [ln for i, ln in enumerate(lines) if i not in drop]


@pytest.mark.parametrize("name", FILES)
def test_refcpu_file_differs_from_its_twin_only_in_imports(name):
    port = (ROOT / "gfx_imagecompress_tpu_torch" / "refcpu" / name).read_text()
    jax = (ROOT / "gfx_imagecompress_tpu" / "refcpu" / name).read_text()
    assert _without_imports(port) == _without_imports(jax)
    assert "jax" not in "\n".join(
        ln for ln in port.splitlines() if ln.lstrip().startswith(
            ("import ", "from ")))


def _ldr_blocks(n, seed):
    return bq.corpus_blocks(1, 16, "gradient")[seed:seed + n]


def _hdr_blocks(n):
    return bq.corpus_blocks(1, 16, "hdr")[:n]


ENCODERS = {
    "bcx_bc1": (lambda m, b: m.encode_bc1_blocks(b), bcx_amd, jbcx, 0),
    "bcx_bc1_punch": (lambda m, b: m.encode_bc1_blocks(
        b, use_alpha=True, alpha_threshold01=0.5), bcx_amd, jbcx, 4),
    "bcx_bc2": (lambda m, b: m.encode_bc2_blocks(b), bcx_amd, jbcx, 8),
    "bcx_bc3": (lambda m, b: m.encode_bc3_blocks(b), bcx_amd, jbcx, 12),
    "bcx_bc4": (lambda m, b: m.encode_bc4_blocks(b[:, :, 0]), bcx_amd, jbcx,
                2),
    "bc7enc16_fast": (lambda m, b: m.encode_blocks(b, fast=True,
                                                   perceptual=False),
                      bc7enc16, jenc16, 6),
    "bc7_amd_q01": (lambda m, b: m.encode_blocks(b, quality=0.1), bc7_amd,
                    jbc7, 10),
    "bc6h_amd_q01": (lambda m, b: m.encode_blocks(b[..., :3], quality=0.1),
                     bc6h_amd, jbc6h, None),
}


@pytest.mark.parametrize("name", list(ENCODERS))
def test_refcpu_encoder_equals_the_jax_packages(name):
    fn, port, jax, seed = ENCODERS[name]
    b = _hdr_blocks(2) if seed is None else _ldr_blocks(3, seed)
    got = fn(port, b)
    assert got.dtype == np.uint32 and got.shape[0] == len(b)
    np.testing.assert_array_equal(got, fn(jax, b))


@pytest.mark.parametrize("kind", ["opaque", "punch", "gradient", "hdr"])
def test_corpus_equals_the_jax_packages(kind):
    np.testing.assert_array_equal(bq.corpus_blocks(2, 16, kind),
                                  jbq.corpus_blocks(2, 16, kind))


@pytest.mark.parametrize("fast", [False, True], ids=["full", "fast"])
def test_matrix_and_keys_equal_the_jax_packages(fast):
    port = bq.config_matrix(fast)
    assert port == jbq.config_matrix(fast)
    assert bq._CACHE_VERSION == jbq._CACHE_VERSION == 2
    for name, _, corpus_cfg, ref_opts, _, _ in port:
        assert (bq._cfg_key(name, corpus_cfg, ref_opts)
                == jbq._cfg_key(name, corpus_cfg, ref_opts))


def test_every_full_matrix_key_is_in_the_cache():
    cache = json.loads(Path(bq._CACHE_PATH).read_text())
    keys = [bq._cfg_key(name, corpus_cfg, ref_opts) for
            name, _, corpus_cfg, ref_opts, _, _ in bq.config_matrix()]
    assert len(keys) == 14
    assert [k for k in keys if k not in cache] == []
    jax_cache = json.loads((ROOT / "gfx_imagecompress_tpu" / "refcpu"
                            / "baseline_cache.json").read_text())
    assert {k: cache[k] for k in keys} == {k: jax_cache[k] for k in keys}


@pytest.fixture(scope="module")
def cheap_rows():
    # one intra-op thread: the rows' many small torch ops run slower, by
    # far, on threads that other test workers' compiles contend for
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return bq.run(only=CHEAP, device="cpu", cached_only=True)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("row", CHEAP)
def test_quality_gate_cheap_row_on_the_plain_versions(cheap_rows, row):
    r = {x["config"]: x for x in cheap_rows}[row]
    assert r["path"] == "cpu" and r["blocks"] == 8192
    assert r["delta_db"] >= bq.TOL_DB, (
        f"{row}: port {r['fw_psnr']} vs ref {r['ref_psnr']} "
        f"(delta {r['delta_db']} dB)")


def test_reference_side_runs_in_spawned_workers():
    """``ref_encode`` keeps the JAX package's ``spawn`` pool: the workers
    import the port, which imports no JAX."""
    b = bq.corpus_blocks(1, 16, "opaque")[:8]
    got = bq.ref_encode("bc4", {}, b, procs=2)
    np.testing.assert_array_equal(got, bcx_amd.encode_bc4_blocks(b[:, :, 0]))


def test_cache_miss_names_its_key_and_nothing_is_written(tmp_path,
                                                          monkeypatch):
    cache = tmp_path / "cache.json"
    cache.write_text("{}")
    monkeypatch.setattr(bq, "_CACHE_PATH", str(cache))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(KeyError, match=r"bc4:276da5b639621982"):
        bq.run(only=["bc4"], device="cpu", cached_only=True)
    assert cache.read_text() == "{}"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cache.json"]


def test_results_file_only_where_named(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "rows.json"
    rows = bq.run(only=["bc4"], device="cpu", cached_only=True, out=str(out))
    assert json.loads(out.read_text()) == rows
    assert sorted(p.name for p in tmp_path.iterdir()) == ["rows.json"]
