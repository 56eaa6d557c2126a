"""The root conftest's per-test time limit, its `eager` marker and its lists
of marked tests.

An inner pytest run with two xdist workers uses copies of this repo's two
conftests and pyproject, the limit cut to a few seconds. The limit ends the
worker process (faulthandler's `exit=True`), so only a run under xdist can
show what follows: the test named and failed, a fresh worker, and the rest
of the run going on.
"""
import ast
import importlib.util
import os
import shutil
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
INNER_LIMIT_S = 3

INNER = '''
import time

import jax
import pytest


def test_sleeper():
    with open("sleeper_start", "w") as f:
        f.write(repr(time.time()))
    time.sleep(30)


def test_passes():
    assert True


@pytest.mark.eager
def test_eager_sees_jit_disabled():
    assert jax.config.jax_disable_jit


def test_unmarked_keeps_jit():
    assert not jax.config.jax_disable_jit
'''


def _root_conftest():
    spec = importlib.util.spec_from_file_location(
        "root_conftest", os.path.join(ROOT, "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_overrun_is_named_and_failed_and_the_run_goes_on(tmp_path):
    src = open(os.path.join(ROOT, "conftest.py")).read()
    line = f"DEFAULT_LIMIT_S = {_root_conftest().DEFAULT_LIMIT_S}\n"
    assert line in src
    (tmp_path / "conftest.py").write_text(
        src.replace(line, f"DEFAULT_LIMIT_S = {INNER_LIMIT_S}\n"))
    tests = tmp_path / "tests"
    tests.mkdir()
    shutil.copy(os.path.join(HERE, "conftest.py"), tests / "conftest.py")
    shutil.copy(os.path.join(ROOT, "pyproject.toml"),
                tmp_path / "pyproject.toml")
    (tests / "test_inner.py").write_text(INNER)
    xml = tmp_path / "inner.xml"
    env = dict(os.environ, PYTHONUNBUFFERED="1", JAX_PLATFORMS="cpu")
    env.pop("RUN_SLOW", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", "-p", "xdist", "-n", "2",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-q",
         f"--junitxml={xml}", "tests/test_inner.py"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines, t_down = [], None
    for line in proc.stdout:
        lines.append(line)
        if t_down is None and "node down" in line:
            t_down = time.time()
    proc.wait(timeout=120)
    out = "".join(lines)

    assert t_down is not None, out
    started = float((tmp_path / "sleeper_start").read_text())
    assert t_down - started < 15, out
    assert "crashed while running 'tests/test_inner.py::test_sleeper'" in out
    assert f"Timeout (0:00:0{INNER_LIMIT_S})!" in out, out
    assert "in test_sleeper" in out, out

    cases = {c.get("name"): c for c in ET.parse(xml).iter("testcase")}
    assert set(cases) == {"test_sleeper", "test_passes",
                          "test_eager_sees_jit_disabled",
                          "test_unmarked_keeps_jit"}, out
    failed = {n for n, c in cases.items()
              if c.find("failure") is not None or c.find("error") is not None}
    assert failed == {"test_sleeper"}, out
    assert proc.returncode == 1, out


@pytest.mark.parametrize("listed", ["EAGER", "SLOW"])
def test_every_listed_node_id_names_a_test(listed):
    """A renamed or moved test would silently lose its mark: each node id
    of the conftest's lists names a module-level test of its file."""
    ids = getattr(_root_conftest(), listed)
    assert ids
    for nodeid in ids:
        path, name = nodeid.split("::")
        tree = ast.parse(open(os.path.join(ROOT, path)).read())
        defs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        assert name in defs, nodeid
