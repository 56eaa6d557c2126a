"""The port's throughput bench (``gfx_imagecompress_tpu_torch/bench.py``) and
its roofline counts (``roofline.py``) on the CPU.

The JAX package's ``bench.main()`` runs with its timer and its writer
replaced by recorders, so that nothing is timed or written: the port's nine
configs must be its nine calls, in its order, on bit-identical blocks with
the same encoder options. The counts moved out of ``chip_smoke.py`` are
pinned to the per-block values ``PERF.md`` lists. Timing needs the card:
``chip_smoke.py`` phase ``bench`` runs ``bench.run()`` there."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from gfx_imagecompress_tpu import bench as jax_bench
from gfx_imagecompress_tpu_torch import bench, roofline
from gfx_imagecompress_tpu_torch.kernels import bc6h
from gfx_imagecompress_tpu_torch.pipeline.blocks import image_to_blocks

ROOT = Path(__file__).resolve().parent.parent

# the JAX bench's encoder -> the port's wrapper
PORT_OF = {
    "encode_bc1_blocks_pallas": "kernels.bc1.encode_bc1_blocks",
    "encode_bc4_blocks_pallas": "kernels.bc4.encode_bc4_blocks",
    "encode_bc5_blocks_pallas": "kernels.bc4.encode_bc5_blocks",
    "encode_bc3_blocks_pallas": "kernels.bc1.encode_bc3_blocks",
    "encode_bc2_blocks_pallas": "kernels.bc1.encode_bc2_blocks",
    "encode_bc6h_blocks_pallas": "kernels.bc6h.encode_bc6h_blocks",
    "encode_bc7_fast_blocks_pallas": "kernels.bc7_fast.encode_bc7_fast_blocks",
    "encode_bc7_blocks_pallas": "kernels.bc7_full.encode_bc7_blocks",
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # one intra-op thread: the counts' many small torch ops run slower, by
    # far, on threads that other test workers contend for
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def benches(tmp_path_factory):
    """(the JAX bench's recorded calls and results, the port's configs on
    the CPU)."""
    calls, emitted = [], []

    def marginal(encode, blocks, n_lo=1, n_hi=5, reps=3):
        fn = getattr(encode, "func", encode)
        calls.append((fn.__name__, dict(getattr(encode, "keywords", {})),
                      np.asarray(blocks), n_lo, n_hi))
        return 1e-3

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bench, "_marginal_time", marginal)
        mp.setattr(jax_bench, "_emit",
                   lambda results, bc1_mts: emitted.append(dict(results)))
        mp.setenv("BENCH_BUDGET_S", "460")
        mp.chdir(tmp_path_factory.mktemp("jax_bench"))
        jax_bench.main()
    return calls, emitted[0], list(bench.configs("cpu"))


def test_nine_calls_in_the_jax_order(benches):
    calls, _, port = benches
    assert len(calls) == len(port) == len(bench.KEYS) == 9
    assert [c[0] for c in port] == list(bench.KEYS)


@pytest.mark.parametrize("i", range(9), ids=bench.KEYS)
def test_config_matches_the_jax_bench(benches, i):
    calls, _, port = benches
    jax_name, jax_kw, jax_blocks, jax_lo, jax_hi = calls[i]
    key, encode, kwargs, blocks, texels, n_lo, n_hi = port[i]
    assert (encode.__module__.split(".", 1)[1] + "." + encode.__name__
            == PORT_OF[jax_name])
    assert kwargs == jax_kw
    assert (n_lo, n_hi) == (jax_lo, jax_hi)
    got = blocks.numpy()
    assert got.dtype == jax_blocks.dtype and got.shape == jax_blocks.shape
    assert np.array_equal(got, jax_blocks)
    assert blocks.is_contiguous()
    assert texels == 16 * blocks.shape[0]


def test_throughput_keys_equal_the_jax_results(benches):
    _, results, _ = benches
    jax_keys = [k for k in results if k.endswith("_mtexels_per_s")]
    assert jax_keys == list(bench.KEYS)
    assert not any(k.endswith("_error") for k in results)


# Per-block counts as PERF.md lists them, at chip_smoke.py's arguments, on
# the main path's images where a count reads the data
def _main_path_blocks(img):
    return image_to_blocks(torch.from_numpy(np.ascontiguousarray(img[None])))


def _k1b():
    x = _main_path_blocks(chip_smoke.with_alpha_field(
        chip_smoke.photo_rgba(1024, 1024, seed=104), 4))
    return roofline.ops_per_block("bc3", x)


def _k2a():
    x = _main_path_blocks(chip_smoke.photo_rgba(512, 512, seed=101)[..., :1])
    return roofline.ops_per_block("bc4", x[:, :, 0].contiguous())


def _k2b():
    x = _main_path_blocks(chip_smoke.photo_rgba(512, 512, seed=102)[..., :2])
    return roofline.ops_per_block("bc5", x)


PINNED = [
    ("K1a", lambda: roofline.ops_bc1(), 53295),
    ("K1b", _k1b, 61437),
    ("K1c", lambda: roofline.ops_per_block("bc2", None), 30445),
    ("K2a", _k2a, 31617),
    ("K2b", _k2b, 62762),
    ("K3_fast", lambda: roofline.ops_bc7_est(), 40640),
    ("K3_full_3ch_2sub_k8", lambda: roofline.ops_bc7_est(k=8), 40896),
    ("K3_full_3ch_3sub_k8",
     lambda: roofline.ops_bc7_est(subsets=3, k=8), 42112),
    ("K3_full_4ch_pca_k8",
     lambda: roofline.ops_bc7_est(chans=4, k=8, pca=True), 83776),
    ("K4", lambda: roofline.ops_bc7_fast(), 114730),
    ("K5", lambda: roofline.ops_bc7_full(0.0), 1321652),
    ("K5_bytes", lambda: roofline.bytes_bc7_full(0.0, 8), 1822),
    ("K6", lambda: roofline.ops_bc6h(**dict(zip(
        ("topk", "iters", "shake"), bc6h._budgets(1.0)))), 142440),
]


@pytest.mark.parametrize("count,want", [(c, w) for _, c, w in PINNED],
                         ids=[p[0] for p in PINNED])
def test_counts_survived_the_move(count, want):
    assert round(count()) == want


def test_chip_smoke_holds_no_copy_of_the_counts():
    text = (ROOT / "chip_smoke.py").read_text()
    for name in ("PEAK_BYTES_PER_S", "PEAK_F32_OPS_PER_S", "FULL_MODES",
                 "def bc4_climb_evals", "def ops_", "def bound",
                 "def bytes_bc7_full"):
        assert name not in text, name


# The bench's own counts on the JAX bench's images, (operations, bytes) per
# block: bytes are the input read once and the words and error written once
# (BC1 and BC4 two words, the others four); the BC4 hill climb, the opaque
# share and the mode 6/7 bar read the images.
BENCH_COUNTS = [(53295, 268), (31082, 76), (62161, 276), (60407, 276),
                (30445, 276), (142440, 212), (142440, 212), (22628, 276),
                (1404666, 276)]


@pytest.mark.parametrize("i", range(9), ids=bench.KEYS)
def test_bench_counts_per_config(benches, i):
    _, _, port = benches
    key, encode, kwargs, blocks, _, _, _ = port[i]
    ops, nbytes = bench.counts(encode, kwargs, blocks)
    assert (round(ops), nbytes) == BENCH_COUNTS[i]


@pytest.mark.parametrize("module,name,kwargs", [
    ("bc1", "encode_bc1_blocks", {"iters": 5}),
    ("bc1", "encode_bc3_blocks", {"a_radius": 3}),
    ("bc4", "encode_bc5_blocks", {"rounds": 1}),
    ("bc6h", "encode_bc6h_blocks", {"mode_mask": 0x3}),
    ("bc7_fast", "encode_bc7_fast_blocks", {"fast": True, "_topk": 4}),
    ("bc7_full", "encode_bc7_blocks", {"quality": 0.5}),
])
def test_counts_refuse_an_option_they_do_not_read(module, name, kwargs):
    """The counts are those of each wrapper's default budget but for the
    options they read; any other option would give a wrong share."""
    from gfx_imagecompress_tpu_torch import kernels
    encode = getattr(getattr(kernels, module), name)
    with pytest.raises(ValueError, match="do not read"):
        bench.counts(encode, kwargs, torch.zeros(4, 16, 4))


def test_the_bench_photo_has_alpha_in_almost_every_block(benches):
    """The JAX photo's alpha noise (sigma 0.01, clipped to 1.0) lies below
    254.999/255 somewhere in almost every block, and clips to 1.0 somewhere
    else: the alpha restriction bars all but 3 of the 2K image's 262,144
    blocks from full BC7's modes 6/7, and fast BC7 runs mode 1 on 3 of the
    1K image's 65,536 blocks. The two shares enter the bench's counts."""
    from gfx_imagecompress_tpu_torch.kernels import bc7_full
    _, _, port = benches
    b1k, b2k = port[7][3], port[8][3]
    assert int((~bc7_full._combined_alpha_bar(b2k, True, True)).sum()) == 3
    opaque = (b1k[..., 3] * 255.0).amin(1) >= 254.999
    assert int(opaque.sum()) == 3
    ops, _ = bench.counts(bc7_full.encode_bc7_blocks, {}, b2k)
    u = 3 / b2k.shape[0]
    assert ops == pytest.approx(
        roofline.ops_bc7_full(u) + roofline.ops_bc7_est(k=8)
        + roofline.ops_bc7_est(subsets=3, k=8)
        + u * roofline.ops_bc7_est(chans=4, k=8, pca=True), rel=1e-12)


def test_run_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run("cpu")


def test_no_cpu_fallback(tmp_path):
    out = tmp_path / "results.json"
    r = subprocess.run(
        [sys.executable, "-m", "gfx_imagecompress_tpu_torch.bench", "--out",
         str(out)], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "PYTHONPATH": str(ROOT)})
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert r.stdout == ""
    assert not out.exists()
    assert not list(tmp_path.iterdir())
