"""The port's in-turns timing scripts start on a machine without a card: they
import (the shared ``scripts/torch_turns.py`` included), parse their options,
and refuse to time anything without a CUDA device, before any build."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ("torch_bc1_est_timing.py", "torch_bc7_full_timing.py",
           "torch_bc6h_bc7fast_timing.py")


def _run(script, *args):
    return subprocess.run(
        [sys.executable, str(ROOT / "scripts" / script), *args],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})


@pytest.mark.parametrize("script", SCRIPTS)
def test_help_names_the_parent_option(script):
    r = _run(script, "--help")
    assert r.returncode == 0, r.stderr
    assert "--parent" in r.stdout and "--reps" in r.stdout


@pytest.mark.parametrize("script", SCRIPTS)
def test_refuses_without_a_cuda_device(script, tmp_path):
    r = _run(script, "--parent", str(tmp_path),
             "--out", str(tmp_path / "out.json"))
    assert r.returncode == 1
    assert "needs a CUDA device" in r.stderr
    assert not (tmp_path / "out.json").exists()
    assert not list(tmp_path.iterdir())
