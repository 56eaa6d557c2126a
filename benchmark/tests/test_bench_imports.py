"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference and the comparison load nothing of the
program either; without a card a run prints no result."""
import json
import shutil
import subprocess
import sys

from benchmark import run, spec

REFERENCE_SIDE = ("benchmark.check", "benchmark.control", "benchmark.counts",
                  "benchmark.textures", "benchmark.reference.full",
                  "benchmark.reference.fast",
                  "benchmark.reference.decode_bc7",
                  "benchmark.encoders.bc7_full",
                  "benchmark.encoders.bc7_fast", "benchmark.loops.bake",
                  "benchmark.loops.serve", "benchmark.devtrace")


def loaded_after(modules) -> set:
    code = ("import sys, json; sys.path.insert(0, %r)\n" % str(spec.ROOT)
            + "".join(f"import {m}\n" for m in modules)
            + "import benchmark.spec as s\n"
            + "for f in (s.HERE / 'metrics').glob('*.py'):\n"
            + "    s._load_file(f, 'm_' + f.stem.replace('.', '_'))\n"
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_reference_side_loads_neither_jax_nor_the_program():
    top = loaded_after(REFERENCE_SIDE)
    assert not top & {"jax", "jaxlib", "flax", "gfx_imagecompress_tpu",
                      "gfx_imagecompress_tpu_torch"}


def test_the_run_and_the_program_load_no_jax():
    top = loaded_after(("benchmark.run", "gfx_imagecompress_tpu_torch.api",
                        "gfx_imagecompress_tpu_torch.kernels"))
    assert "gfx_imagecompress_tpu_torch" in top
    assert not top & set(run.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gfx_imagecompress_tpu_torch_x",
                        sys.modules["json"])
    assert "gfx_imagecompress_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gfx_imagecompress_tpu.sub",
                        sys.modules["json"])
    assert "gfx_imagecompress_tpu" in run.forbidden_modules()


def test_no_card_or_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, and
    here, where there is no card, a run exits non-zero and prints
    nothing."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "bc7_amd_q1.bake_opaque", "--seed", "3000000000",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == ""
