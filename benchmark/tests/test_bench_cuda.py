"""On the card: a short run of every cell through the program's kernels
comes out correct, with its metrics and device fields. Skips without a
card (``cuda_device`` decides)."""
import json

import pytest

from benchmark import run, spec

CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(cuda_device, capsys, cell, trace):
    rc = run.main(["--workload", cell, "--seed", "3000000001",
                   "--seconds", "2", "--trace", str(trace)])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert "breakdown" in res
